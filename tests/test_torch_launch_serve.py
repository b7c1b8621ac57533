"""The port's serving entry point (``python -m repro_torch.launch.serve``) against
the reference package's (``python -m repro.launch.serve``) on the same
flags, on the CPU: ``--mode ddc`` over both engines with and without a
seeded fault plan, and ``--mode track`` on dist.  Every hardware-free
field of the JSON line must be equal: comm bytes and collectives,
refreshes, retries, quarantine counts, journal entries, routing counters,
``query_clustered_frac``, ``query_version``, the track census and the
rounded tracks.  ``--mode lm`` (the default mode) on every architecture's
tiny configuration: the reference's JSON keys (and the device), tokens in
the vocabulary, and, given the reference's own seeded parameters, prompts
and frames (carried across with ``params_from_jax``), the reference's
greedy tokens; ``--mesh-devices`` above 1 serves over that many gloo
ranks, with the one-process tokens."""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

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


# The reference's serve_lm line, and the port's device beside it.
LM_KEYS = {"requests", "generated_tokens", "wall_s", "tok_per_s", "sample_output"}
LM_ARGS = ["--tiny", "--requests", "2", "--prompt-len", "8", "--gen", "5"]


@pytest.mark.parametrize("arch", tconfigs.all_archs())
def test_lm_mode_serves_every_arch(arch, capsys):
    out = tserve.main(["--arch", arch, *LM_ARGS, "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == LM_KEYS | {"device"} and line["device"] == "cpu"
    assert line["requests"] == 2 and line["generated_tokens"] == 10
    assert out.shape == (2, 5) and out.dtype == torch.int64
    vocab = tconfigs.get_config(arch).vocab
    assert 0 <= int(out.min()) and int(out.max()) < vocab
    assert line["sample_output"] == out[0].tolist()


def test_lm_mode_is_the_default_and_exits_zero():
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                           "mamba2-1.3b", *LM_ARGS, "--device", "cpu"], cwd=ROOT, env=env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert set(json.loads(proc.stdout.strip().splitlines()[-1])) == LM_KEYS | {"device"}


def test_lm_mode_equals_the_reference_given_its_draws(capsys):
    """The reference's ``serve_lm`` draws parameters, prompts and frames
    from one ``jax.random`` key; handed the same draws, the port's
    ``serve_lm`` generates the reference's tokens, and both lines carry
    the same keys but the port's device."""
    arch, seed = "whisper-small", 3
    argv = ["--arch", arch, *LM_ARGS, "--seed", str(seed)]
    want = jserve.main(argv)
    want_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = jconfigs.get_config(arch).tiny()
    key = jax.random.PRNGKey(seed)
    params = JT.init_params(cfg, key)
    prompts = jax.random.randint(key, (2, 8), 0, cfg.vocab)
    frames = jax.random.normal(key, (2, cfg.frontend_seq, cfg.d_model)) * 0.1
    ns = argparse.Namespace(arch=arch, tiny=True, requests=2, prompt_len=8, gen=5,
                            temperature=0.0, mesh_devices=0, seed=seed, device="cpu")
    got = tserve.serve_lm(
        ns, model=TT.params_from_jax(tconfigs.get_config(arch).tiny(),
                                     jax.tree.map(np.asarray, params), device="cpu"),
        prompts=torch.as_tensor(np.array(prompts)), frames=torch.as_tensor(np.array(frames)))
    got_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(got_line) - {"device"} == set(want_line) == LM_KEYS
    assert got_line["sample_output"] == want_line["sample_output"]


def test_lm_mode_sampling_follows_the_seed(capsys):
    """--temperature > 0 samples with the seeded generator: the same seed
    gives the same tokens, another seed others (the reference's
    ``jax.random`` sampling cannot be reproduced: ROADMAP C)."""
    runs = [tserve.main(["--arch", "qwen3-8b", *LM_ARGS, "--temperature", "1.0", "--seed",
                         str(seed), "--device", "cpu"]) for seed in (0, 0, 1)]
    capsys.readouterr()
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert int(runs[0].max()) < tconfigs.get_config("qwen3-8b").vocab


def test_lm_mode_refuses_several_cards(capsys):
    """``--mesh-devices 2`` serves over 2 gloo ranks (the reference's host
    mesh of ``data`` lanes, parameters unsharded): each rank generates for
    its 2 of the 4 requests (llama4-scout: its MoE layers route the whole
    batch, gathered over ``data``, as one card does) and the tokens gathered
    to rank 0 equal the one-process run's exactly; the line names the
    ranks and the backend."""
    argv = ["--arch", "llama4-scout-17b-a16e", "--tiny", "--requests", "4", "--prompt-len",
            "8", "--gen", "4", "--device", "cpu"]
    want = tserve.main(argv)
    capsys.readouterr()
    got = tserve.main(argv + ["--mesh-devices", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert torch.equal(got, want) and got.shape == (4, 4)
    assert line["ranks"] == 2 and line["backend"] == "gloo" and not line["staged"]
    assert set(line) == LM_KEYS | {"device", "ranks", "backend", "staged"}


def test_serve_lm_torch_example(capsys):
    """examples/serve_lm_torch.py (serve_lm.py's counterpart) on the CPU:
    ``serve.main`` with the example's flags, the same tokens; run as a
    script it exits 0 and prints the serve line."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("serve_lm_torch",
                                                  ROOT / "examples" / "serve_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    flags = ["--requests", "2", "--gen", "4", "--device", "cpu"]
    got = mod.main(flags)
    want = tserve.main(["--arch", "qwen3-8b", "--tiny", "--requests", "2", "--prompt-len", "32",
                        "--gen", "4", "--temperature", "0.0", "--device", "cpu"])
    assert torch.equal(got, want) and got.shape == (2, 4)
    capsys.readouterr()
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "serve_lm_torch.py"), *flags],
                          cwd=ROOT, env=env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(line) == LM_KEYS | {"device"} and line["generated_tokens"] == 8
