"""The port's serving entry point (``python -m repro_torch.launch.serve``) against
the reference package's (``python -m repro.launch.serve``) on the same
flags, on the CPU: ``--mode ddc`` over both engines with and without a
seeded fault plan, and ``--mode track`` on dist.  Every hardware-free
field of the JSON line must be equal: comm bytes and collectives,
refreshes, retries, quarantine counts, journal entries, routing counters,
``query_clustered_frac``, ``query_version``, the track census and the
rounded tracks.  ``--mode lm`` is not ported yet and exits non-zero."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
# Wall-clock fields, the port's device, and the reference's process-wide
# jit cache size.
NOT_COMPARED = {"ingest_ms_per_batch", "query_ms", "match_ms_per_refresh", "wall_ms_per_frame",
                "qps", "p50_ms", "p99_ms", "jit_cache_entries", "device"}


def env():
    e = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    e["PYTHONPATH"] = str(ROOT / "src")
    e["JAX_PLATFORMS"] = "cpu"
    return e


def run_both(args):
    """Both entry points on ``args``, side by side; their JSON lines."""
    procs = [subprocess.Popen([sys.executable, "-m", mod, *args, *extra], cwd=ROOT,
                              env=env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for mod, extra in (("repro_torch.launch.serve", ["--device", "cpu"]),
                                ("repro.launch.serve", []))]
    lines = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, out + err
        lines.append(json.loads(out.strip().splitlines()[-1]))
    return lines


# 1,024 points and 12 frames: half the defaults, to keep the pair
# of processes a case short.
@pytest.mark.parametrize("args", [
    ["--mode", "ddc", "--backend", "stream", "--shards", "4", "--n", "1024"],
    ["--mode", "ddc", "--backend", "dist", "--shards", "4", "--n", "1024"],
    ["--mode", "ddc", "--backend", "stream", "--shards", "4", "--n", "1024", "--fault-seed", "3"],
    ["--mode", "ddc", "--backend", "dist", "--shards", "4", "--n", "1024", "--fault-seed", "3"],
    ["--mode", "track", "--backend", "dist", "--shards", "4", "--steps", "12"],
], ids=["ddc-stream", "ddc-dist", "ddc-stream-faults", "ddc-dist-faults", "track-dist"])
def test_serve_cli_equals_reference(args):
    got, want = run_both(args)
    assert got["device"] == "cpu"
    assert set(got) - {"device"} == set(want)
    for key in sorted(set(want) - NOT_COMPARED):
        assert got[key] == want[key], (key, got[key], want[key])
    if args[1] == "ddc":
        assert got["backend"] == args[3] and got["bytes_total"] > 0
        assert got["refreshes"] > 0 and got["journal_entries"] > 0
    else:
        assert got["tracks"] and got["births"] > 0


def test_lm_mode_is_not_ported():
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--mode", "lm",
                           "--arch", "qwen3-8b", "--tiny"], cwd=ROOT, env=env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "ROADMAP A10" in proc.stderr and "not ported" in proc.stderr
