"""The port's phase-2 schedules against the reference package's, on the CPU.

The reference runs its schedules as collectives inside ``shard_map``, so
it needs one device per lane: this module doubles as the script that runs
it on an 8-device host mesh (the device count must be set before JAX
starts, so it runs in a subprocess):

    PYTHONPATH=src python tests/test_torch_schedules.py OUT.npz [NAME,NAME,...]

writes, for every case of ``CASES`` (or the named ones), the reference's global labels, maps,
global ClusterSet and ``CommMeter`` counts (and, for K-Means, each lane's
initial centres).  The tests hold the port's one-device ``make_ddc_fn``
to them bit for bit, the port's ``CommMeter`` to the committed
``BENCH_phase2.json`` rows with K <= 8, and ``match_to_global``,
``farthest_point_subsample`` and ``merge_from_d2(merge_refine="fps")`` to
the jitted reference functions.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import ddc as jddc  # noqa: E402
from repro.core import geometry as jgeo  # noqa: E402
from repro.data import spatial as jsp  # noqa: E402
from repro_torch.core import ddc as tddc  # noqa: E402
from repro_torch.core import geometry as tgeo  # noqa: E402
from repro_torch.data import spatial as tsp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _layout(name, **over):
    spec = tsp.PHASE2_LAYOUTS[name]
    cfg = dict(eps=spec["eps"], min_pts=spec["min_pts"], grid=spec["grid"],
               max_verts=spec["max_verts"], max_clusters=spec["max_clusters"])
    return name, cfg | over


# name -> (layout, DDCConfig fields, lanes).  Two layouts at K in {4, 8}
# under async and tree with degree 2 and 3; trees with partial groups
# (K = 3, 5, 6); K-Means lanes; the fps merge; contours that overflow.
CASES = {}
for _lay in ("rings", "worm"):
    for _k in (4, 8):
        CASES[f"{_lay}-k{_k}-async"] = (*_layout(_lay, schedule="async"), _k)
        for _d in (2, 3):
            CASES[f"{_lay}-k{_k}-tree{_d}"] = (*_layout(_lay, schedule="tree", tree_degree=_d),
                                                _k)
CASES |= {
    "rings-k6-tree2": (*_layout("rings", schedule="tree"), 6),
    "rings-k5-tree3": (*_layout("rings", schedule="tree", tree_degree=3), 5),
    "linked_ovals-k3-tree2": (*_layout("linked_ovals", schedule="tree"), 3),
    "blobs-k4-kmeans-async": ("blobs", dict(eps=0.03, grid=64, max_verts=64,
                                            max_clusters=8, local_algo="kmeans"), 4),
    "blobs-k6-kmeans-tree3": ("blobs", dict(eps=0.03, grid=64, max_verts=64, max_clusters=8,
                                            local_algo="kmeans", schedule="tree",
                                            tree_degree=3), 6),
    "rings-k4-fps-async": (*_layout("rings", schedule="async", merge_refine="fps"), 4),
    "rings-k4-fps-sync": (*_layout("rings", schedule="sync", merge_refine="fps"), 4),
    # Contours cut at 24 vertices, against the vertex-budget rule: the
    # schedules' clusterings may then differ from sync's, the port's from
    # the reference's may not.
    "rings-k4-v24-async": (*_layout("rings", schedule="async", max_verts=24), 4),
    "rings-k8-v24-tree2": (*_layout("rings", schedule="tree", max_verts=24), 8),
    "rings-k8-v24-sync": (*_layout("rings", schedule="sync", max_verts=24), 8),
}


def case_points(layout: str, k: int) -> np.ndarray:
    if layout == "blobs":
        pts = tsp.make_blobs(2048, 5, seed=6, spread=0.015)[0]
    else:
        pts = tsp.PHASE2_LAYOUTS[layout]["make"](2048)
    return pts[:len(pts) // k * k]


def reference_outputs(path: str, names=None) -> None:
    """Run every case (or the named ones) through the reference's
    make_ddc_fn on a host mesh and save its outputs to ``path``."""
    from repro.core import kmeans as jkm
    from repro.launch import mesh as mesh_mod

    out = {}
    for name in names or CASES:
        layout, fields, k = CASES[name]
        cfg = jddc.DDCConfig(**fields)
        pts = case_points(layout, k)
        meter = jddc.CommMeter()
        run = jddc.make_ddc_fn(mesh_mod.make_host_mesh(k), "data", cfg, meter)
        glabels, gcs, my_map = run(jnp.asarray(pts), jnp.ones(len(pts), bool))
        out[f"{name}/glabels"] = np.asarray(glabels)
        out[f"{name}/my_map"] = np.asarray(my_map)
        for f in jddc.ClusterSet._fields:
            out[f"{name}/gcs.{f}"] = np.asarray(getattr(gcs, f))
        out[f"{name}/meter"] = np.array(json.dumps(meter.snapshot()))
        if cfg.local_algo == "kmeans":
            per = len(pts) // k
            init = jax.jit(jkm.kmeanspp_init, static_argnames=("k",))
            out[f"{name}/init"] = np.stack([
                np.asarray(init(jax.random.PRNGKey(0), jnp.asarray(pts[i * per:(i + 1) * per]),
                                jnp.ones(per, bool), min(cfg.kmeans_k, cfg.max_clusters)))
                for i in range(k)])
    np.savez(path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("schedules") / "reference.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, __file__, str(path)], capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", list(CASES))
def test_schedule_equals_reference(name, reference):
    """Global labels, every lane's map, the global ClusterSet and the
    meter's counts equal the reference's lanes on a host mesh."""
    layout, fields, k = CASES[name]
    pts = case_points(layout, k)
    cfg = tddc.DDCConfig(**fields)
    meter = tddc.CommMeter()
    init = reference.get(f"{name}/init")
    trace: dict = {}
    glabels, gcs, my_map = tddc.make_ddc_fn(cfg, k, device="cpu", meter=meter, init=init)(
        pts, np.ones(len(pts), bool), trace)
    np.testing.assert_array_equal(glabels.numpy(), reference[f"{name}/glabels"])
    np.testing.assert_array_equal(my_map.numpy(), reference[f"{name}/my_map"])
    for f in tddc.ClusterSet._fields:
        want = reference[f"{name}/gcs.{f}"]
        got = getattr(gcs, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert meter.snapshot() == json.loads(str(reference[f"{name}/meter"]))
    assert trace["schedule"] == cfg.schedule
    assert int(gcs.valid.sum()) >= 1 and not bool(gcs.overflow)


def test_cut_contours_change_the_tree(reference):
    """Against the vertex-budget rule (contours cut at 24 vertices) the
    reference's own tree schedule gives another clustering than its sync;
    the port equals the reference in both (``test_schedule_equals_reference``)."""
    tree = reference["rings-k8-v24-tree2/glabels"]
    sync = reference["rings-k8-v24-sync/glabels"]
    assert int(reference["rings-k8-v24-sync/gcs.counts"].max()) == 24
    assert not tddc.same_clustering(sync, tree)


BENCH = json.loads((ROOT / "BENCH_phase2.json").read_text())


@pytest.mark.parametrize("k", (2, 4, 8))
@pytest.mark.parametrize("layout", list(BENCH["layouts"]))
def test_meter_equals_bench_phase2(layout, k):
    """The committed BENCH_phase2.json rows with K <= 8: the meter's four
    columns, the global cluster count and the match with ddc_host."""
    spec = BENCH["layouts"][layout]
    pts = tsp.PHASE2_LAYOUTS[layout]["make"](spec["n"])
    host = tddc.ddc_host(pts, k, spec["eps"], spec["min_pts"], contour="grid")[0]
    rows = [r for r in BENCH["rows"] if r["layout"] == layout and r["shards"] == k]
    assert sorted(r["schedule"] for r in rows) == ["async", "sync", "tree"]
    for row in rows:
        cfg = tddc.DDCConfig(eps=spec["eps"], min_pts=spec["min_pts"], grid=spec["grid"],
                             max_verts=spec["max_verts"], max_clusters=spec["max_clusters"],
                             schedule=row["schedule"])
        meter = tddc.CommMeter()
        glabels, gcs, _ = tddc.make_ddc_fn(cfg, k, device="cpu", meter=meter)(
            pts, np.ones(len(pts), bool))
        snap = meter.snapshot()
        got = {"merge_steps": snap["merge_steps"], "merge_slots": snap["merge_slots"],
               "bytes_exchanged": snap["bytes_total"], "collectives": snap["collectives"],
               "buffer_bytes": cfg.buffer_bytes(), "n_clusters": int(gcs.valid.sum()),
               "overflow": bool(gcs.overflow),
               "matches_host": tddc.same_clustering(glabels.numpy(), host)}
        assert got == {key: row[key] for key in got}, row["schedule"]


class TestScheduleRules:
    def test_async_needs_a_power_of_two(self):
        cs = tddc.empty_clusterset(tddc.DDCConfig(max_clusters=4, max_verts=8), "cpu")
        batch = tddc.stack_clustersets([cs] * 3)
        with pytest.raises(ValueError):
            tddc.merge_async(batch, tddc.DDCConfig(max_clusters=4, max_verts=8))
        with pytest.raises(ValueError):
            tddc.make_ddc_fn(tddc.DDCConfig(), 3, device="cpu")

    def test_one_lane(self):
        """One lane: async and tree return the lane's own set and the
        identity map on its valid slots; sync re-extracts it in one merge."""
        pts = tsp.make_blobs(256, 3, seed=1)[0]
        base = tddc.DDCConfig(eps=0.05, max_clusters=8, max_verts=32, grid=32)
        _, cs = tddc.local_phase(torch.from_numpy(pts), torch.ones(256, dtype=torch.bool), base)
        batch = tddc.stack_clustersets([cs])
        ident = torch.where(cs.valid, torch.arange(8, dtype=torch.int32), -1)
        for fn in (tddc.merge_async, tddc.merge_tree):
            stats: dict = {}
            meter = tddc.CommMeter()
            gcs, maps = fn(batch, base, meter, stats)
            assert all(torch.equal(a, b) for a, b in zip(gcs, cs))
            assert torch.equal(maps[0], ident) and stats.get("merge_calls", 0) == 0
            assert meter.snapshot() == {"bytes_total": 0, "collectives": 0,
                                        "merge_steps": 0, "merge_slots": 0}
        stats = {}
        gcs, maps = tddc.merge_sync(batch, base, None, stats)
        assert stats["merge_calls"] == 1 and int(gcs.valid.sum()) == int(cs.valid.sum())

    def test_merge_calls(self):
        """Fold counts: sync 1; async K − 1 (one per butterfly block); tree
        one per group whose leader's index is a multiple of every stride
        (at K = 5, D = 2: lanes 0, 2, 4, then 0, 4 — lane 4 folds with an
        empty set — then 0)."""
        pts = tsp.make_blobs(1024, 4, seed=2)[0]
        base = tddc.DDCConfig(eps=0.05, max_clusters=8, max_verts=32, grid=32,
                              block_sparse="never")
        for schedule, d, k, calls in (("sync", 2, 8, 1), ("async", 2, 8, 7),
                                      ("tree", 2, 8, 7), ("tree", 3, 8, 4),
                                      ("tree", 4, 8, 3), ("tree", 2, 5, 6)):
            trace: dict = {}
            cfg = dataclasses.replace(base, schedule=schedule, tree_degree=d)
            n = 1024 // k * k
            tddc.make_ddc_fn(cfg, k, device="cpu")(pts[:n], np.ones(n, bool), trace)
            assert trace["merge_calls"] == calls, (schedule, d, k)


def _random_sets(rng, c, v, spread):
    centres = rng.uniform(0.2, 0.8, (c, 1, 2))
    contours = (centres + rng.normal(0, spread, (c, v, 2))).astype(np.float32)
    counts = rng.integers(0, v + 1, c).astype(np.int32)
    valid = rng.random(c) > 0.25
    valid[0] = True
    counts[0] = v
    sizes = np.where(valid, rng.integers(1, 100, c), 0).astype(np.int32)
    contours = np.where((np.arange(v)[None, :] < counts[:, None])[..., None], contours, 0)
    return (contours.astype(np.float32), np.where(valid, counts, 0).astype(np.int32), sizes,
            valid, np.asarray(False))


@pytest.mark.parametrize("seed", range(4))
def test_match_to_global_equals_reference(seed):
    """Each local slot's global slot on random sets, some within the merge
    radius of a global set and some not: the jitted reference's
    fma(dy, dy, dx·dx) form, its tie rule and its threshold."""
    rng = np.random.default_rng(seed)
    c, v = 8, 24
    cfg_j = jddc.DDCConfig(eps=0.004, grid=64, max_clusters=c, max_verts=v)
    cfg_t = tddc.DDCConfig.from_dict(dataclasses.asdict(cfg_j))
    local = _random_sets(rng, c, v, 0.03)
    glob = _random_sets(rng, c, v, 0.03)
    want = jax.jit(jddc.match_to_global, static_argnames=("cfg",))(
        jddc.ClusterSet(*map(jnp.asarray, local)), jddc.ClusterSet(*map(jnp.asarray, glob)),
        cfg_j)
    got = tddc.match_to_global(tddc.clusterset_from_numpy(local, "cpu"),
                               tddc.clusterset_from_numpy(glob, "cpu"), cfg_t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) >= 0).any() and (np.asarray(want) == -1).any()


@pytest.mark.parametrize("n_valid", [0, 1, 5, 40, 300])
def test_farthest_point_subsample_equals_reference(n_valid):
    """Order, count and zero padding, including fewer valid points than k
    and none at all (masked points sit at 1e30)."""
    rng = np.random.default_rng(n_valid)
    pts = (0.5 + rng.normal(0, 0.1, (300, 2))).astype(np.float32)
    pts[7] = pts[3]  # a duplicate: a tie in the farthest distance
    masks = np.zeros((3, 300), bool)
    for row in masks:
        row[rng.choice(300, n_valid, replace=False)] = True
    k = 32
    fps = jax.jit(jgeo.farthest_point_subsample, static_argnames=("k",))
    got_p, got_c = tgeo.farthest_point_subsample(torch.from_numpy(pts), torch.from_numpy(masks), k)
    for i, mask in enumerate(masks):
        want_p, want_c = fps(jnp.asarray(pts), jnp.asarray(mask), k)
        np.testing.assert_array_equal(got_p[i].numpy(), np.asarray(want_p))
        assert int(got_c[i]) == int(want_c) and got_c.dtype == torch.int32


@pytest.mark.parametrize("k", (2, 4))
def test_merge_from_d2_fps_equals_reference(k):
    """The fps branch of the merge: a reference-built batch and its d2
    matrix give the reference's merged ClusterSet and maps bit for bit."""
    pts = jsp.make_rings(2048)
    cfg_j = jddc.DDCConfig(eps=0.008, grid=64, max_verts=80, max_clusters=8,
                           merge_refine="fps")
    cfg_t = tddc.DDCConfig.from_dict(dataclasses.asdict(cfg_j))
    parts = np.array_split(np.arange(len(pts)), k)
    sets = [jddc.local_phase(jnp.asarray(pts[i]), jnp.ones(len(i), bool), cfg_j)[1]
            for i in parts]
    jb = jax.tree.map(lambda *xs: jnp.stack(xs), *sets)
    jd2 = jddc.contour_pair_d2(jb, cfg_j)
    jm, jmaps = jddc.merge_from_d2(jb, jd2, cfg_j)
    tb = tddc.clusterset_from_numpy(jax.tree.map(np.asarray, jb), "cpu")
    tm, tmaps = tddc.merge_from_d2(tb, torch.from_numpy(np.array(jd2)), cfg_t)
    np.testing.assert_array_equal(tmaps.numpy(), np.asarray(jmaps))
    for f in tddc.ClusterSet._fields:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                      err_msg=f)
    assert int(tm.valid.sum()) >= 2


def test_pytree_wire_bytes_equals_reference():
    from repro.parallel import compress as jcompress
    from repro_torch.parallel import compress as tcompress

    cfg = tddc.DDCConfig()
    cs = tddc.empty_clusterset(cfg, "cpu")
    jcs = jddc.empty_clusterset(jddc.DDCConfig())
    assert tcompress.pytree_wire_bytes(cs) == jcompress.pytree_wire_bytes(jcs) \
        == cfg.buffer_bytes()
    tree = {"a": np.zeros((3, 4), np.int16), "b": [1.5, torch.zeros(5, dtype=torch.bool)]}
    assert tcompress.pytree_wire_bytes(tree) == 3 * 4 * 2 + 4 + 5


if __name__ == "__main__":
    reference_outputs(sys.argv[1], sys.argv[2].split(",") if len(sys.argv) > 2 else None)
