"""The port's DDC facade (``repro_torch.ddc``) against the reference
package's (``repro.ddc``), on the CPU.  Every comparison is exact.

- ``DDCConfig.validate`` passes and fails where the reference's does, with
  the same message, on tests/test_ddc_api.py's matrix and one case for
  every other rule.
- The host backend's labels equal the reference's on the four
  ``PHASE2_LAYOUTS`` at K in {2, 4, 8}; the jit backend's equal the
  reference's jit backend at K in {2, 4, 8} under sync, async and tree,
  with the same snapshot query answers and ``CommMeter`` counts.  The
  reference's jit backend needs one device per shard, so this module
  doubles as the script that runs it on an 8-device host mesh (the device
  count must be set before JAX starts, so it runs in a subprocess):

      PYTHONPATH=src python tests/test_torch_facade.py OUT.npz LAYOUT

  The tier-1 cases run ``linked_ovals``; the other layouts are the
  ``slow`` sweep.
- Snapshots move both ways (manifest JSON and npz arrays equal), and
  every ``SnapshotError`` path of tests/test_faults.py raises.
- The quickstart's modules (``core.partitioner``'s splits and sizes,
  ``core.simulate``) equal the reference's, and
  ``examples/quickstart_torch.py`` ends with the reference's lines.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.ddc as J  # noqa: E402
import repro_torch.ddc as T  # noqa: E402
from repro.core import partitioner as jpart  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro_torch.core import partitioner as tpart  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.data import spatial  # noqa: E402
from repro_torch.serve import faults as tfaults  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N = 2048
SHARDS = (2, 4, 8)
SCHEDULES = ("sync", "async", "tree")
QUICK_LAYOUT = "linked_ovals"
LAYOUT_FIELDS = ("eps", "min_pts", "grid", "max_verts", "max_clusters")


def layout_kw(layout: str) -> dict:
    spec = spatial.PHASE2_LAYOUTS[layout]
    return {k: spec[k] for k in LAYOUT_FIELDS}


def layout_points(layout: str, n: int = N) -> np.ndarray:
    return spatial.PHASE2_LAYOUTS[layout]["make"](n)


def probes(pts: np.ndarray) -> np.ndarray:
    """Query points: fitted points, points jittered near them, and points
    outside the bounds."""
    rng = np.random.default_rng(5)
    near = pts[rng.integers(0, len(pts), 200)] + rng.uniform(-0.01, 0.01, (200, 2))
    far = rng.uniform(1.5, 2.0, (40, 2))
    return np.concatenate([pts[::7], near, far]).astype(np.float32)


def reference_jit(path: str, layout: str) -> None:
    """The reference's jit backend on ``layout`` at every K and schedule:
    labels, snapshot query answers and comm counts, saved to ``path``."""
    pts = layout_points(layout)
    out = {}
    for k in SHARDS:
        for sched in SCHEDULES:
            model = J.DDC(J.DDCConfig(**layout_kw(layout), backend="jit", shards=k,
                                      schedule=sched)).fit(pts)
            out[f"{k}/{sched}/labels"] = model.labels_
            out[f"{k}/{sched}/query"] = np.asarray(model.query(probes(pts)))
            out[f"{k}/{sched}/comm"] = np.array(json.dumps(model.comm_stats()))
    np.savez(path, **out)


_JIT_REFERENCE: dict = {}


def jit_reference(layout: str, tmp_path_factory) -> dict:
    if layout not in _JIT_REFERENCE:
        path = tmp_path_factory.mktemp("facade") / f"{layout}.npz"
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
        env.pop("XLA_FLAGS", None)
        proc = subprocess.run([sys.executable, __file__, str(path), layout],
                              capture_output=True, text=True, timeout=900, env=env)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        with np.load(path) as f:
            _JIT_REFERENCE[layout] = dict(f)
    return _JIT_REFERENCE[layout]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- validate ------------------------------------------------------------------

# tests/test_ddc_api.py's negative matrix and its accepted cases, then one
# case for every other rule of _check_math and _check_deployment (and
# configs next to each rule's edge that pass).
VALIDATE_CASES = [
    dict(eps=-1.0), dict(min_pts=0), dict(grid=1), dict(bounds=(0.0, 0.0, 0.0, 1.0)),
    dict(backend="no-such-backend"), dict(schedule="ring-allreduce"),
    dict(local_algo="optics"), dict(merge_refine="chaikin"), dict(merge_mode="approx"),
    dict(tree_degree=1), dict(shards=0), dict(backend="jit", schedule="async", shards=6),
    dict(backend="stream", capacity=8, max_batch=64),
    dict(backend="host", schedule="async", shards=6),
    dict(backend="stream", schedule="async", shards=6),
    dict(bounds=(0.0, 1.0, 1.0, 1.0)), dict(eps=0.0), dict(merge_eps=0.0), dict(merge_eps=0.1),
    dict(max_clusters=0), dict(max_verts=3), dict(max_verts=4),
    dict(local_algo="kmeans", kmeans_k=0), dict(local_algo="dbscan", kmeans_k=0),
    dict(tree_degree=2, schedule="tree"), dict(merge_refine="fps"),
    dict(backend="jit", schedule="async", shards=8), dict(backend="jit", schedule="tree", shards=6),
    dict(max_batch=0), dict(max_queries=0), dict(capacity=255, max_batch=256),
    dict(capacity=256, max_batch=256), dict(max_retries=-1), dict(retry_backoff=-0.5),
    dict(journal_limit=0), dict(agg_degree=4), dict(agg_degree=4, backend="jit"),
    dict(agg_degree=1, backend="stream"), dict(agg_degree=3, backend="stream"),
    dict(agg_degree=4, backend="stream"), dict(track=True), dict(track=True, backend="jit"),
    dict(track=True, backend="stream"), dict(track_history=1), dict(match_min_overlap=1.0),
    dict(match_min_overlap=-0.1), dict(match_min_overlap=0.5), dict(queue_depth=0),
    dict(query_bucket_min=0), dict(query_bucket_min=512), dict(query_bucket_min=24),
    dict(query_bucket_min=256), dict(max_staleness=-1.0), dict(max_staleness=float("inf")),
    dict(max_staleness=0.0),
]


def outcome(cfg_cls, kw, sample=None):
    try:
        cfg = cfg_cls(**kw)
        assert cfg.validate(sample=sample) is cfg
    except ValueError as e:
        return type(e).__name__, str(e)
    return "ok", None


@pytest.mark.parametrize("kw", VALIDATE_CASES, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_validate_matches_reference(kw):
    want = outcome(J.DDCConfig, kw)
    assert outcome(T.DDCConfig, kw) == want


@pytest.mark.parametrize("layout,over,match", [
    ("worm", dict(grid=128, max_verts=32, max_clusters=8), "merged contour"),
    ("noise_heavy", dict(max_clusters=2), "max_clusters"),
    ("rings", {}, None),
    ("worm", {}, None),
])
def test_sizing_probe_matches_reference(layout, over, match):
    kw = layout_kw(layout) | over
    pts = layout_points(layout)
    want = outcome(J.DDCConfig, kw, pts)
    assert outcome(T.DDCConfig, kw, pts) == want
    assert (want[0] == "ok") == (match is None)
    if match:
        assert match in want[1]


def test_backend_names_and_unported_engines():
    assert set(T.BACKENDS) == {"host", "jit", "stream"}
    assert set(T.UNPORTED) == {"dist"}
    assert set(T.BACKENDS) | set(T.UNPORTED) == set(J.BACKENDS)
    for name in T.UNPORTED:
        cfg = T.DDCConfig(backend=name, capacity=256).validate()
        with pytest.raises(T.ConfigError, match="no port yet"):
            T.DDC(cfg, device="cpu")


def test_config_fields_equal_reference():
    import dataclasses

    j = [(f.name, f.default) for f in dataclasses.fields(J.DDCConfig)]
    t = [(f.name, f.default) for f in dataclasses.fields(T.DDCConfig)]
    assert t == j
    cfg = T.DDCConfig(eps=0.02, backend="jit", shards=8, schedule="tree")
    assert cfg.to_manifest() == J.DDCConfig(eps=0.02, backend="jit", shards=8,
                                            schedule="tree").to_manifest()
    assert T.DDCConfig.from_manifest(cfg.to_manifest()) == cfg
    core = cfg.core()
    assert type(core).__module__ == "repro_torch.core.ddc"
    assert dataclasses.asdict(core) == dataclasses.asdict(
        J.DDCConfig(eps=0.02, backend="jit", shards=8, schedule="tree").core())


# -- labels ----------------------------------------------------------------------


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("layout", sorted(spatial.PHASE2_LAYOUTS))
def test_host_backend_equals_reference(layout, k):
    pts = layout_points(layout)
    want = J.DDC(J.DDCConfig(**layout_kw(layout), backend="host", shards=k)).fit(pts)
    got = T.DDC(T.DDCConfig(**layout_kw(layout), backend="host", shards=k),
                device="cpu").fit(pts)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    assert got.labels_.dtype == np.int32
    q = probes(pts)
    np.testing.assert_array_equal(np.asarray(got.query(q)), np.asarray(want.query(q)))
    assert got.comm_stats() == want.comm_stats()


def check_jit(layout, k, sched, tmp_path_factory):
    ref = jit_reference(layout, tmp_path_factory)
    pts = layout_points(layout)
    model = T.DDC(T.DDCConfig(**layout_kw(layout), backend="jit", shards=k, schedule=sched),
                  device="cpu").fit(pts)
    np.testing.assert_array_equal(model.labels_, ref[f"{k}/{sched}/labels"])
    np.testing.assert_array_equal(np.asarray(model.query(probes(pts))),
                                  ref[f"{k}/{sched}/query"])
    assert model.comm_stats() == json.loads(str(ref[f"{k}/{sched}/comm"]))


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("k", SHARDS)
def test_jit_backend_equals_reference(k, sched, tmp_path_factory):
    check_jit(QUICK_LAYOUT, k, sched, tmp_path_factory)


@pytest.mark.slow
@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("layout", sorted(set(spatial.PHASE2_LAYOUTS) - {QUICK_LAYOUT}))
def test_jit_backend_equals_reference_sweep(layout, k, sched, tmp_path_factory):
    check_jit(layout, k, sched, tmp_path_factory)


def test_jit_meter_counts_first_run_of_a_width():
    """The reference's meter counts while its pipeline traces: once per
    compiled width.  A refit at the same padded width adds nothing; a new
    width counts again."""
    pts = layout_points("rings", 500)
    kw = layout_kw("rings") | dict(backend="jit", shards=1)
    model = T.DDC(T.DDCConfig(**kw), device="cpu").fit(pts)
    ref = J.DDC(J.DDCConfig(**kw)).fit(pts)
    for m in (model, ref):
        m.labels_
        m.partial_fit(0, pts[:4])    # 504 points: the same 512-wide runner
        m.labels_
    assert model.comm_stats() == ref.comm_stats()
    for m in (model, ref):
        m.partial_fit(0, pts)        # 1004 points: a 1024-wide runner
        m.labels_
    assert model.comm_stats() == ref.comm_stats()
    assert model.backend.refits == ref.backend.refits == 3


def test_partial_fit_equals_fit():
    pts = layout_points("linked_ovals")
    cfg = T.DDCConfig(**layout_kw("linked_ovals"), backend="host", shards=2)
    whole = T.DDC(cfg, device="cpu").fit(pts)
    piecewise = T.DDC(cfg, device="cpu")
    for shard, idx in enumerate(np.array_split(np.arange(len(pts)), 2)):
        for off in range(0, len(idx), 300):
            piecewise.partial_fit(shard, pts[idx[off:off + 300]])
    np.testing.assert_array_equal(whole.labels_, piecewise.labels_)
    np.testing.assert_array_equal(whole.points_, piecewise.points_)


def test_batch_backends_refuse_streaming_calls():
    model = T.DDC(T.DDCConfig(**layout_kw("rings"), backend="host", shards=2), device="cpu")
    with pytest.raises(T.ConfigError, match="stream"):
        model.expire(0.0)
    with pytest.raises(T.ConfigError, match="tracking"):
        model.tracks()
    with pytest.raises(T.ConfigError, match="out of range"):
        model.partial_fit(2, np.zeros((1, 2)))


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.DDCConfig(**layout_kw("rings"), backend="jit", shards=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.DDC(cfg)
    model = T.DDC(cfg, device="cpu").fit(layout_points("rings", 256))
    model.save(str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match="CUDA"):
        T.DDC.load(str(tmp_path / "ckpt"))


# -- snapshots -------------------------------------------------------------------


def read_snapshot(path):
    with open(os.path.join(path, "manifest.json")) as f:
        text = f.read()
    with np.load(os.path.join(path, "state.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return text, arrays


@pytest.mark.parametrize("backend,k", [("host", 4), ("jit", 1)])
def test_snapshots_move_both_ways(backend, k, tmp_path):
    """A port snapshot loads in the reference and a reference snapshot in
    the port, with equal labels and query answers; the two packages write
    the same manifest and the same arrays."""
    pts = layout_points("rings")
    kw = layout_kw("rings") | dict(backend=backend, shards=k, schedule="sync")
    port = T.DDC(T.DDCConfig(**kw), device="cpu").fit(pts)
    ref = J.DDC(J.DDCConfig(**kw)).fit(pts)
    port.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "ref"))
    text_p, arr_p = read_snapshot(tmp_path / "port")
    text_r, arr_r = read_snapshot(tmp_path / "ref")
    assert text_p == text_r
    assert sorted(arr_p) == sorted(arr_r)
    for name in arr_r:
        assert arr_p[name].dtype == arr_r[name].dtype, name
        np.testing.assert_array_equal(arr_p[name], arr_r[name], err_msg=name)

    in_ref = J.DDC.load(str(tmp_path / "port"))
    in_port = T.DDC.load(str(tmp_path / "ref"), device="cpu")
    assert in_ref.config.to_manifest() == port.config.to_manifest()
    assert in_port.config == port.config
    q = probes(pts)
    for model in (in_ref, in_port):
        np.testing.assert_array_equal(model.labels_, ref.labels_)
        np.testing.assert_array_equal(model.points_, ref.points_)
        np.testing.assert_array_equal(np.asarray(model.query(q)), np.asarray(ref.query(q)))
    assert in_port.backend.refits == 0
    assert in_port.comm_stats() == in_ref.comm_stats()


def fitted_port(faults=None):
    pts = layout_points("rings")
    cfg = T.DDCConfig(**layout_kw("rings"), backend="host", shards=2)
    return T.DDC(cfg, faults=faults, device="cpu").fit(pts)


def test_truncated_npz_raises_snapshot_error(tmp_path):
    model = fitted_port()
    path = str(tmp_path / "snap")
    model.save(path)
    labels_before = model.labels_.copy()
    target = os.path.join(path, "state.npz")
    with open(target, "r+b") as f:
        f.truncate(os.path.getsize(target) // 2)
    with pytest.raises(T.SnapshotError, match="truncated or corrupt"):
        T.DDC.load(path, device="cpu")
    np.testing.assert_array_equal(model.labels_, labels_before)


@pytest.mark.parametrize("manifest,match", [
    ('{"format": "repro-ddc/v1", "config": {', "unreadable manifest"),
    ('{"format": "repro-ddc/v999", "config": {}, "state": {}}', "unknown snapshot format"),
    ('[1, 2]', "unknown snapshot format"),
    ('{"format": "repro-ddc/v1", "state": {}}', "malformed manifest"),
    ('{"format": "repro-ddc/v1", "config": {"no_such_field": 1, "bounds": [0, 0, 1, 1]}, '
     '"state": {}}', "malformed manifest"),
])
def test_bad_manifest_raises_snapshot_error(tmp_path, manifest, match):
    model = fitted_port()
    path = str(tmp_path / "snap")
    model.save(path)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write(manifest)
    with pytest.raises(T.SnapshotError, match=match):
        T.DDC.load(path, device="cpu")
    with pytest.raises(J.SnapshotError, match=match):
        J.DDC.load(path)


def test_state_that_does_not_restore_raises_snapshot_error(tmp_path):
    model = fitted_port()
    path = str(tmp_path / "snap")
    model.save(path)
    np.savez(os.path.join(path, "state.npz"), shard_0=np.zeros((4, 2), np.float32))
    with pytest.raises(T.SnapshotError, match="does not restore"):
        T.DDC.load(path, device="cpu")


def test_missing_dir_raises_snapshot_error(tmp_path):
    with pytest.raises(T.SnapshotError):
        T.DDC.load(str(tmp_path / "nope"), device="cpu")


def test_torn_snapshot_fault_is_detected(tmp_path):
    """FaultPlan(torn_snapshot=True) byte-tears exactly one save; loading
    it fails, and the next save is whole again."""
    model = fitted_port(faults=tfaults.FaultPlan(torn_snapshot=True))
    torn = str(tmp_path / "torn")
    model.save(torn)
    with pytest.raises(T.SnapshotError):
        T.DDC.load(torn, device="cpu")
    whole = str(tmp_path / "whole")
    model.save(whole)
    restored = T.DDC.load(whole, device="cpu")
    np.testing.assert_array_equal(restored.labels_, model.labels_)


def test_save_overwrites_in_place(tmp_path):
    model = fitted_port()
    path = str(tmp_path / "snap")
    model.save(path)
    model.partial_fit(0, layout_points("rings", 64))
    model.save(path)
    assert sorted(os.listdir(tmp_path)) == ["snap"]
    np.testing.assert_array_equal(T.DDC.load(path, device="cpu").labels_, model.labels_)


# -- faults, partitioner, simulate -------------------------------------------------


def test_fault_plan_equals_reference():
    kw = dict(seed=11, shards=4, n_faults=6, horizon=3)
    tp, jp = tfaults.FaultPlan.random(**kw), jfaults.FaultPlan.random(**kw)
    assert [vars(e) for e in tp.events] == [vars(e) for e in jp.events]
    seq_t, seq_j = [], []
    for plan, seq in ((tp, seq_t), (jp, seq_j)):
        for shard in range(4):
            for attempt in (0, 1, 2, 0, 1, 0):
                ev = plan.on_delta(shard, attempt)
                seq.append(None if ev is None else (ev.kind, ev.shard, ev.delivery))
    assert seq_t == seq_j
    payload = {"contours": np.ones((4, 8, 2), np.float32), "counts": np.full(4, 3, np.int32),
               "sizes": np.full(4, 5, np.int32)}
    for kind in ("poison", "corrupt"):
        a, b = tp.mangle(kind, payload), jp.mangle(kind, payload)
        for name in payload:
            np.testing.assert_array_equal(a[name], b[name])


@pytest.mark.parametrize("n,k", [(10, 3), (2048, 8), (1, 4)])
def test_partitioner_splits_equal_reference(n, k):
    for a, b in zip(tpart.split_block(n, k), jpart.split_block(n, k)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tpart.split_random(n, k, seed=3), jpart.split_random(n, k, seed=3)):
        np.testing.assert_array_equal(a, b)
    pts = np.random.default_rng(n).uniform(-0.1, 1.1, (n, 2))
    got, want = tpart.split_spatial(pts, k), jpart.split_spatial(pts, k)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("speeds", [[1, 2, 3, 4, 5, 6, 7, 8], [0.5] * 8, [10, 1, 1, 1]])
def test_capacity_aware_equals_reference(speeds):
    np.testing.assert_array_equal(tpart.capacity_aware_sizes(1000, speeds),
                                  jpart.capacity_aware_sizes(1000, speeds))
    np.testing.assert_array_equal(tpart.capacity_aware_sizes(1000, speeds, 3.0),
                                  jpart.capacity_aware_sizes(1000, speeds, 3.0))
    for a, b in zip(tpart.split_capacity_aware(1000, speeds, seed=2),
                    jpart.split_capacity_aware(1000, speeds, seed=2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["I", "II", "III", "IV"])
def test_scenarios_and_simulation_equal_reference(which):
    for kw in ({}, {"n": 4000}, {"speeds": [1, 2, 3, 4, 5, 6, 7, 8]}):
        sizes = tpart.scenario_sizes(which, **kw)
        assert sizes == jpart.scenario_sizes(which, **kw)
        for sched in ("sync", "async"):
            got = tsim.simulate(tsim.PAPER_MACHINES, sizes, sched)
            want = jsim.simulate(jsim.PAPER_MACHINES, sizes, sched)
            assert vars(got) == vars(want)
    assert [tsim.phase1_time(m, 1234) for m in tsim.PAPER_MACHINES] == \
        [jsim.phase1_time(m, 1234) for m in jsim.PAPER_MACHINES]
    assert tsim.sequential_time(tsim.PAPER_MACHINES[0], 5000) == \
        jsim.sequential_time(jsim.PAPER_MACHINES[0], 5000)
    with pytest.raises(ValueError):
        tpart.scenario_sizes("V")


def test_quickstart_torch_ends_like_the_reference():
    """examples/quickstart_torch.py on the CPU (host and stream backends,
    a smaller set): exit 0, the MATCH line, a bit-identical restore, and
    the reference's sync-vs-async table, computed here from its modules;
    ``--backend dist`` is refused."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
                           "--backend", "host", "--n", "3000", "--device", "cpu"],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert any(line.endswith("-> MATCH") for line in lines), proc.stdout
    assert "snapshot -> restore: labels bit-identical = True" in lines
    table = []
    for scen in ("I", "IV"):
        sizes = jpart.scenario_sizes(scen)
        s = jsim.simulate(jsim.PAPER_MACHINES, sizes, "sync").makespan
        a = jsim.simulate(jsim.PAPER_MACHINES, sizes, "async").makespan
        table.append(f"scenario {scen}: sync {s:8.0f} ms | async {a:8.0f} ms "
                     f"({'async wins' if a < s else 'sync wins'})")
    assert lines[-2:] == table
    refused = subprocess.run([sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
                              "--backend", "dist", "--n", "600", "--device", "cpu"],
                             capture_output=True, text=True, timeout=300, env=env)
    assert refused.returncode != 0 and "no port yet" in refused.stderr
    streamed = subprocess.run([sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
                               "--backend", "stream", "--n", "3000", "--device", "cpu"],
                              capture_output=True, text=True, timeout=300, env=env)
    assert streamed.returncode == 0, streamed.stdout + streamed.stderr
    slines = streamed.stdout.splitlines()
    assert any(line.endswith("-> MATCH") for line in slines), streamed.stdout
    assert "snapshot -> restore: labels bit-identical = True" in slines
    assert slines[-2:] == table
    assert math.isfinite(float(lines[-1].split("async")[1].split("ms")[0]))


if __name__ == "__main__":
    reference_jit(sys.argv[1], sys.argv[2])
