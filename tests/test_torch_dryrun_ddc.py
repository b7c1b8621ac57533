"""The port's dry run (``repro_torch.launch.dryrun_ddc``) on the CPU at 8
and 16 lanes, against the reference's formulas and its ``CommMeter``.

The reference's meter counts while its schedules trace inside
``shard_map``, which needs one device per lane:
``tests/_torch_ref_script.py dryrun_meters`` traces the reference's
``make_ddc_fn`` with the dry run's config on an 8-device host mesh in a
subprocess, started with the module so that it works while the cells run.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_ref_script import DRYRUN_CONFIG, DRYRUN_POINTS, DRYRUN_SCHEDULES  # noqa: E402
from repro import ddc as jfacade  # noqa: E402
from repro_torch.data import spatial as tsp  # noqa: E402
from repro_torch.launch import dryrun_ddc  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# The cells run on the CPU with the dry run's config at a 64-cell raster
# (the rasters are most of the CPU's time); B, the meter's unit, depends
# only on C and V.
CPU_CONFIG = dataclasses.replace(dryrun_ddc.CONFIG, grid=64)


@pytest.fixture(autouse=True, scope="module")
def _reference_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "meters.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_ref_script.py"),
                             "dryrun_meters", str(path)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    yield proc, path
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def reference(_reference_run):
    proc, path = _reference_run
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def cells():
    """Both lane counts × the three schedules on 1,024 make_d2 points."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    pts = tsp.make_d2(DRYRUN_POINTS, seed=1)
    try:
        return {(k, s): dryrun_ddc.run_cell(k, s, pts, CPU_CONFIG, device="cpu")
                for k in (8, 16) for s in dryrun_ddc.SCHEDULES}
    finally:
        torch.set_num_threads(prev)


def test_config_is_the_references():
    """The dry run's DDCConfig, lane counts and schedules, field for field
    (the reference builds them inside its ``main``)."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun_ddc.py").read_text()
    assert "for lanes in (256, 512):" in src
    assert 'for sched in ("sync", "tree", "async"):' in src
    assert "DDCConfig(eps=0.01, min_pts=4, grid=256, max_clusters=64,\n" \
           "                    max_verts=128, backend=\"jit\")" in src
    assert dryrun_ddc.LANES == (256, 512) and dryrun_ddc.SCHEDULES == DRYRUN_SCHEDULES
    assert dataclasses.asdict(dryrun_ddc.CONFIG) == \
        dataclasses.asdict(jfacade.DDCConfig(**DRYRUN_CONFIG))


@pytest.mark.parametrize("k", (8, 16, 256, 512))
@pytest.mark.parametrize("sched", ("sync", "tree", "async"))
def test_wire_budget_is_the_references_formula(k, sched):
    """``wire_budget_bytes`` as the reference's run_cell computes it, with
    its max(bit_length − 1, 1) for the tree and async."""
    cfg = jfacade.DDCConfig(**DRYRUN_CONFIG, schedule=sched, shards=k)
    want = cfg.core().buffer_bytes() * ((k - 1) if sched == "sync"
                                        else max(k.bit_length() - 1, 1))
    assert dryrun_ddc.wire_budget_bytes(dryrun_ddc.CONFIG, k, sched) == want


@pytest.mark.parametrize("k", (8, 16))
@pytest.mark.parametrize("sched", ("sync", "tree", "async"))
def test_cells_on_the_cpu(k, sched, cells):
    """Each cell's fields and its meter against K·(K−1)·B (sync), K·log2 K·B
    (async) and the tree's (log2 K · K/2 + K − 1)·B.  The schedules'
    clusterings may differ: the dry run's contours are cut (DESIGN.md §7)."""
    rec = cells[(k, sched)]
    b = dryrun_ddc.CONFIG.core().buffer_bytes()
    levels = k.bit_length() - 1
    assert rec["cell"] == f"ddc_spatial_{k}lanes_{sched}" and rec["points"] == DRYRUN_POINTS
    assert rec["bytes_total"] == {"sync": k * (k - 1), "async": k * levels,
                                  "tree": levels * k // 2 + k - 1}[sched] * b
    assert rec["merge_calls"] == (1 if sched == "sync" else k - 1)
    assert rec["peak_memory_bytes"] is None and rec["phase1_s"] > 0 and rec["phase2_s"] > 0
    assert not rec["overflow"] and rec["n_clusters"] >= 1
    assert rec["launches"] == {} and rec["compact_launches"] == 0  # the CPU launches nothing


def test_meters_equal_the_references(reference, cells):
    """The port's meters at 8 lanes equal the reference's trace-time
    CommMeter for each schedule."""
    for sched, want in reference.items():
        got = {key: cells[(8, sched)][key] for key in want}
        assert got == want, sched


def test_ratio_and_main(capsys):
    """The sync/async ratio line: (K−1)/log2 K exactly; ``main`` prints a
    line per cell and the ratio."""
    recs = [{"cell": f"ddc_spatial_512lanes_{s}", "bytes_total": b}
            for s, b in (("sync", 512 * 511), ("async", 512 * 9))]
    r = dryrun_ddc.sync_async_ratio(recs, 512)
    assert r["sync_async_wire_ratio"] == r["theory"] == 511 / 9
    out = dryrun_ddc.main(["--points", "128", "--lanes", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and [json.loads(x)["cell"] for x in lines[:3]] == \
        [f"ddc_spatial_2lanes_{s}" for s in dryrun_ddc.SCHEDULES]
    assert lines[3] == "# 2-lane phase-2 wire bytes: sync/async = 1.0x " \
                       "(theory (K-1)/log2(K) = 1.0x)"


def test_cuda_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_ddc.run_cell(8, "sync", np.zeros((64, 2), np.float32))
