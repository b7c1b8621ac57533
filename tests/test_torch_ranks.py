"""DDC across processes (``ddc_shard`` on gloo ranks, ``launch/ranks.py``)
against the port's one-device schedules and the reference's, on the CPU.

One spawn of 8 CPU ranks runs every case of
``test_torch_schedules.CASES`` through ``ddc_shard`` (a case with K < 8
on a group of the first K ranks while the others idle) and, on a group of
6, ``ddc_shard`` with the configurations it must refuse.  Each case must
equal the port's one-device ``make_ddc_fn`` bit for bit — global labels,
maps, every rank's global ClusterSet, the ``CommMeter`` — and the bytes
the ranks handed to gloo must sum to the meter's.  ``SUBSET`` is also held
to the reference's ``make_ddc_fn`` on an 8-device host mesh, which
``tests/test_torch_schedules.py`` runs as a script in two subprocesses
beside the spawn.
"""
import concurrent.futures
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import _torch_ranks_probe as probe  # noqa: E402
from repro.core import kmeans as jkm  # noqa: E402
from repro_torch.core import ddc as tddc  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from test_torch_schedules import CASES, case_points  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
SUBSET = ("rings-k8-tree2", "worm-k4-async", "rings-k5-tree3", "rings-k8-v24-sync",
          "rings-k4-fps-sync", "blobs-k4-kmeans-async")


def reference_init(pts, k, cfg):
    """Each lane's initial K-Means centres as the reference's jitted
    ``kmeans`` draws them (``PRNGKey(0)``), fed to both ports' runs."""
    per = len(pts) // k
    init = jax.jit(jkm.kmeanspp_init, static_argnames=("k",))
    k_cent = min(cfg.kmeans_k, cfg.max_clusters)
    return np.stack([np.asarray(init(jax.random.PRNGKey(0), jnp.asarray(pts[i * per:(i + 1) * per]),
                                     jnp.ones(per, bool), k_cent)) for i in range(k)])


def case_inputs(name):
    layout, fields, k = CASES[name]
    pts = case_points(layout, k)
    cfg = tddc.DDCConfig(**fields)
    init = reference_init(pts, k, cfg) if cfg.local_algo == "kmeans" else None
    return pts, cfg, k, init


def one_device(pts, cfg, k, init):
    meter = tddc.CommMeter()
    glabels, gcs, maps = tddc.make_ddc_fn(cfg, k, device="cpu", meter=meter, init=init)(
        pts, np.ones(len(pts), bool))
    return glabels.numpy(), [t.numpy() for t in gcs], maps.numpy(), meter.snapshot()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawn, the one-device runs (in this process, while the ranks
    work) and the reference's subprocess, all three at once."""
    tmp = tmp_path_factory.mktemp("ranks")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    # The subset in two subprocesses, which compile their cases side by side.
    parts = [(tmp / f"reference{i}.npz", SUBSET[i::2]) for i in range(2)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "test_torch_schedules.py"),
                               str(path), ",".join(names)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for path, names in parts]
    try:
        inputs = {name: case_inputs(name) for name in CASES}
        cases = [ranks.ddc_case(pts, np.ones(len(pts), bool), cfg, k, init=init)
                 for pts, cfg, k, init in inputs.values()]
        cases.append(ranks.Case(probe.bad_configs, 6))
        timing: dict = {}
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            spawn = pool.submit(ranks.run_cases, cases, WORLD, device="cpu",
                                timeout=300, timing=timing)
            oracle = {name: one_device(*args) for name, args in inputs.items()}
            out = spawn.result()
        logs = [proc.communicate(timeout=300)[0] for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    reference = {}
    for proc, log, (path, _) in zip(procs, logs, parts):
        assert proc.returncode == 0, log
        with np.load(path) as f:
            reference |= dict(f)
    return {"inputs": inputs, "reference": reference, "timing": timing, "probe": out[-1],
            "one_device": oracle,
            "ranks": {name: ranks.ddc_result(recs) for name, recs in zip(CASES, out)}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_equal_one_device(name, runs):
    """Global labels, maps, every rank's global ClusterSet and meter, and
    the summed sent bytes, against the one-device schedules."""
    k = CASES[name][2]
    res = runs["ranks"][name]
    glabels, gcs, maps, meter = runs["one_device"][name]
    assert res.glabels.dtype == np.int32 and res.maps.dtype == np.int32
    np.testing.assert_array_equal(res.glabels, glabels)
    np.testing.assert_array_equal(res.maps, maps)
    assert len(res.ranks) == k
    for rec in res.ranks:
        for f, got, want in zip(tddc.ClusterSet._fields, rec["gcs"], gcs):
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        assert rec["meter"] == meter
        assert rec["launches"] == {}          # the CPU runs the plain versions
    assert res.meter == meter
    assert res.sent_bytes == meter["bytes_total"]


@pytest.mark.parametrize("name", SUBSET)
def test_ranks_equal_reference(name, runs):
    """The reference's make_ddc_fn on an 8-device host mesh: labels, maps,
    the global ClusterSet, the meter, and the fed initial centres."""
    ref = runs["reference"]
    res = runs["ranks"][name]
    np.testing.assert_array_equal(res.glabels, ref[f"{name}/glabels"])
    np.testing.assert_array_equal(res.maps, ref[f"{name}/my_map"])
    for f, got in zip(tddc.ClusterSet._fields, res.gcs):
        want = ref[f"{name}/gcs.{f}"]
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert res.meter == json.loads(str(ref[f"{name}/meter"]))
    if f"{name}/init" in ref:
        np.testing.assert_array_equal(runs["inputs"][name][3], ref[f"{name}/init"])


def test_wire_and_folds_per_rank(runs):
    """Who sends and who folds: sync all-gathers (K − 1)·B from every rank
    and folds once on each; async swaps B and folds on every rank in each
    of log2 K rounds; the tree's members send once up, leaders fold, and
    the broadcast comes down the same edges (K = 8, D = 2: rank 0 folds 3
    times, ranks 4, 2 and 6 twice, once and once, the odd ranks never).
    The reference's permutation lists also carry accumulators of ranks
    that lead nothing at a level (3 → 1 and 7 → 5 at stride 2; 5 → 1,
    6 → 2 and 7 → 3 at stride 4), which the receivers drop: 12 hops up,
    7 down."""
    b = {name: tddc.DDCConfig(**CASES[name][1]).buffer_bytes()
         for name in ("rings-k8-v24-sync", "rings-k8-async", "rings-k8-tree2")}
    sync = runs["ranks"]["rings-k8-v24-sync"].ranks
    assert [r["sent_bytes"] for r in sync] == [7 * b["rings-k8-v24-sync"]] * 8
    assert [r["merge_calls"] for r in sync] == [1] * 8
    butterfly = runs["ranks"]["rings-k8-async"].ranks
    assert [r["sent_bytes"] for r in butterfly] == [3 * b["rings-k8-async"]] * 8
    assert [r["merge_calls"] for r in butterfly] == [3] * 8
    tree = runs["ranks"]["rings-k8-tree2"].ranks
    assert [r["merge_calls"] for r in tree] == [3, 0, 1, 0, 2, 0, 1, 0]
    assert [r["sent_bytes"] // b["rings-k8-tree2"] for r in tree] == [3, 1, 2, 2, 3, 2, 3, 3]
    assert runs["timing"]["spawn_s"] > 0 and runs["timing"]["group_init_s"] >= 0


def test_bad_configs_raise_in_every_rank(runs):
    """async on 6 ranks, tree_degree 1 and an unknown schedule raise
    ValueError in every rank of the group, before phase 1."""
    assert len(runs["probe"]) == 6
    for got in runs["probe"]:
        assert set(got) == set(probe.BAD_CONFIGS)
        assert "power-of-two" in got["async-k6"]
        assert "tree_degree" in got["tree-degree-1"]
        assert "schedule='ring'" in got["unknown-schedule"]
        assert all(msg.startswith("ValueError") for msg in got.values())


@pytest.mark.parametrize("name", list(probe.BAD_CONFIGS))
def test_bad_configs_raise_before_the_spawn(name):
    pts = np.zeros((60, 2), np.float32)
    cfg = tddc.DDCConfig(**probe.BAD_CONFIGS[name])
    with pytest.raises(ValueError):
        ranks.run_ddc_ranks(pts, np.ones(60, bool), cfg, 6, device="cpu")


def test_a_rank_that_raises_fails_the_call():
    """Rank 1 raises while rank 0 waits for it: the call fails with rank
    1's traceback and returns, leaving no rank behind."""
    with pytest.raises(Exception, match="rank 1 gives up") as info:
        ranks.run_ranks(probe.raise_on_rank_one, 2, device="cpu", timeout=120)
    assert "Traceback" in str(info.value)


def test_cuda_is_refused_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ranks.run_ranks(probe.raise_on_rank_one, 2)
