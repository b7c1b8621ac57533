"""The port's DDC pipeline against the reference package's, on the CPU:
local_phase, merge_many (incl. a reference-built batch carried across),
the one-device sync pipeline, the config and the data generators."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import ddc as jddc  # noqa: E402
from repro.core import partitioner  # noqa: E402
from repro.data import spatial as jsp  # noqa: E402
from repro_torch.core import ddc as tddc  # noqa: E402
from repro_torch.data import spatial as tsp  # noqa: E402

JCFG = jddc.DDCConfig(eps=0.05, min_pts=5, max_clusters=16, max_verts=64, grid=96)
TCFG = tddc.DDCConfig.from_dict(dataclasses.asdict(JCFG))
WORM_J = jddc.DDCConfig(eps=0.015, min_pts=5, max_clusters=8, max_verts=96, grid=32)
WORM_T = tddc.DDCConfig.from_dict(dataclasses.asdict(WORM_J))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_same_set(t_cs, j_cs):
    for f in tddc.ClusterSet._fields:
        got, want = getattr(t_cs, f), np.asarray(getattr(j_cs, f))
        assert got.numpy().dtype == want.dtype, f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


def local_both(pts, n_shards, jcfg=JCFG, tcfg=TCFG):
    out = []
    for idx in np.array_split(np.arange(len(pts)), n_shards):
        jd, jc = jddc.local_phase(jnp.asarray(pts[idx]), jnp.ones(len(idx), bool), jcfg)
        td, tc = tddc.local_phase(torch.from_numpy(pts[idx]),
                                  torch.ones(len(idx), dtype=torch.bool), tcfg)
        out.append((jd, jc, td, tc))
    return out


def jstack(sets):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *sets)


class TestConfig:
    def test_round_trip_and_derived_values(self):
        for jcfg in (JCFG, jddc.DDCConfig(), jddc.DDCConfig(merge_eps=0.02, grid=48)):
            tcfg = tddc.DDCConfig.from_dict(dataclasses.asdict(jcfg))
            assert tcfg.to_dict() == dataclasses.asdict(jcfg)
            assert tcfg.merge_radius == jcfg.merge_radius
            assert tcfg.buffer_bytes() == jcfg.buffer_bytes()
        assert [f.name for f in dataclasses.fields(tddc.DDCConfig)] == \
            [f.name for f in dataclasses.fields(jddc.DDCConfig)]
        assert tddc.DDCConfig() == tddc.DDCConfig.from_dict(dataclasses.asdict(jddc.DDCConfig()))
        with pytest.raises(ValueError):
            tddc.DDCConfig.from_dict({"eps": 0.1, "nope": 1})


class TestLocalPhase:
    @pytest.mark.parametrize("name", ["blobs4", "blobs3", "d1"])
    def test_equals_reference(self, name):
        pts, cfgs = {
            "blobs4": (jsp.make_blobs(300, 4, seed=0)[0], (JCFG, TCFG)),
            "blobs3": (jsp.make_blobs(200, 3, seed=1)[0], (JCFG, TCFG)),
            "d1": (jsp.make_d1(1500, seed=0), (
                jddc.DDCConfig(eps=0.02, min_pts=4, max_clusters=8, max_verts=48, grid=64),
                tddc.DDCConfig(eps=0.02, min_pts=4, max_clusters=8, max_verts=48, grid=64))),
        }[name]
        ((jd, jc, td, tc),) = local_both(pts, 1, *cfgs)
        assert td.dtype == torch.int32
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert_same_set(tc, jc)

    def test_masked_halves(self):
        pts, _ = jsp.make_blobs(400, 5, seed=3)
        m = np.arange(len(pts)) % 2 == 0
        for mask in (m, ~m):
            jd, jc = jddc.local_phase(jnp.asarray(pts), jnp.asarray(mask), JCFG)
            td, tc = tddc.local_phase(torch.from_numpy(pts), torch.from_numpy(mask), TCFG)
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
            assert_same_set(tc, jc)


class TestMergeMany:
    @pytest.mark.parametrize("case", ["blobs600x4", "blobs500x8", "worm512x8"])
    def test_equals_reference(self, case):
        pts, k, jcfg, tcfg = {
            "blobs600x4": (jsp.make_blobs(600, 5, seed=7, spread=0.012)[0], 4, JCFG, TCFG),
            "blobs500x8": (jsp.make_blobs(500, 4, seed=8)[0], 8, JCFG, TCFG),
            "worm512x8": (jsp.make_worm(512, waves=1, amp=0.1), 8, WORM_J, WORM_T),
        }[case]
        sets = local_both(pts, k, jcfg, tcfg)
        for _, jc, _, tc in sets:
            assert_same_set(tc, jc)
        jm, jmaps = jddc.merge_many(jstack([s[1] for s in sets]), jcfg)
        tm, tmaps = tddc.merge_many(tddc.stack_clustersets([s[3] for s in sets]), tcfg)
        assert tmaps.dtype == torch.int32
        np.testing.assert_array_equal(tmaps.numpy(), np.asarray(jmaps))
        assert_same_set(tm, jm)

    def test_reference_batch_carried_across(self):
        """A batch built entirely by the reference package merges
        identically in the port."""
        pts, _ = jsp.make_blobs(500, 4, seed=9)
        parts = np.array_split(np.arange(len(pts)), 4)
        jb = jstack([jddc.local_phase(jnp.asarray(pts[i]), jnp.ones(len(i), bool), JCFG)[1]
                     for i in parts])
        tb = tddc.clusterset_from_numpy(jax.tree.map(np.asarray, jb), device="cpu")
        assert_same_set(tb, jb)
        as_dict = tddc.clusterset_from_numpy(jax.tree.map(np.asarray, jb)._asdict(), "cpu")
        assert all(torch.equal(a, b) for a, b in zip(tb, as_dict))
        jm, jmaps = jddc.merge_many(jb, JCFG)
        tm, tmaps = tddc.merge_many(tb, TCFG)
        np.testing.assert_array_equal(tmaps.numpy(), np.asarray(jmaps))
        assert_same_set(tm, jm)
        back = tddc.clusterset_to_numpy(tm)
        assert all(isinstance(a, np.ndarray) for a in back)
        np.testing.assert_array_equal(back.contours, np.asarray(jm.contours))

    def test_exclude_and_empty_sets(self):
        pts, _ = jsp.make_blobs(200, 3, seed=2)
        ((_, jc, _, tc),) = local_both(pts, 1)
        je, te = jddc.empty_clusterset(JCFG), tddc.empty_clusterset(TCFG, device="cpu")
        assert_same_set(te, je)
        jb, tb = jstack([je, jc, je, jc]), tddc.stack_clustersets([te, tc, te, tc])
        jd2 = jddc.contour_pair_d2(jb, JCFG)
        td2 = tddc.contour_pair_d2(tb, TCFG)
        np.testing.assert_array_equal(td2.numpy(), np.asarray(jd2))
        for exclude in (None, np.array([False, True, False, False]),
                        np.array([True, True, True, True])):
            jm, jmaps = jddc.merge_from_d2(
                jb, jd2, JCFG, None if exclude is None else jnp.asarray(exclude))
            tm, tmaps = tddc.merge_from_d2(
                tb, td2, TCFG, None if exclude is None else torch.from_numpy(exclude))
            np.testing.assert_array_equal(tmaps.numpy(), np.asarray(jmaps))
            assert_same_set(tm, jm)

    def test_merge_pair(self):
        pts, _ = jsp.make_blobs(300, 4, seed=4)
        m = np.arange(len(pts)) < 150
        jsets = [jddc.local_phase(jnp.asarray(pts), jnp.asarray(x), JCFG)[1] for x in (m, ~m)]
        tsets = [tddc.local_phase(torch.from_numpy(pts), torch.from_numpy(x), TCFG)[1]
                 for x in (m, ~m)]
        jm, ja, jb = jddc.merge_pair(*jsets, JCFG)
        tm, ta, tb = tddc.merge_pair(*tsets, TCFG)
        assert_same_set(tm, jm)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


class TestMakeDDCFn:
    @pytest.mark.parametrize("name,k", [("d2", 4), ("rings", 8), ("noise_heavy", 2)])
    def test_equals_reference_lanes(self, name, k):
        """glabels and my_map equal the reference's local_phase per lane,
        merge_many, and merge_sync's per-lane lookup."""
        make, eps, min_pts, grid, max_verts, max_clusters = tsp.PARITY_CASES[name]
        pts = make()
        jcfg = jddc.DDCConfig(eps=eps, min_pts=min_pts, grid=grid, max_verts=max_verts,
                              max_clusters=max_clusters, schedule="sync")
        tcfg = tddc.DDCConfig.from_dict({**dataclasses.asdict(jcfg), "block_sparse": "never"})
        per = len(pts) // k
        lanes = [jddc.local_phase(jnp.asarray(pts[i * per:(i + 1) * per]),
                                  jnp.ones(per, bool), jcfg) for i in range(k)]
        batch = jstack([cs for _, cs in lanes])
        _, maps = jddc.merge_many(batch, jcfg)
        my_map = jnp.where(batch.valid, maps, -1)
        want_labels = np.concatenate([
            np.asarray(jnp.where(d >= 0, my_map[i][jnp.clip(d, 0)], -1))
            for i, (d, _) in enumerate(lanes)])
        glabels, gcs, t_map = tddc.make_ddc_fn(tcfg, k, device="cpu")(
            pts, np.ones(len(pts), bool))
        assert glabels.shape == (len(pts),) and glabels.dtype == torch.int32
        assert t_map.shape == (k * max_clusters,) and t_map.dtype == torch.int32
        np.testing.assert_array_equal(t_map.numpy(), np.asarray(my_map).reshape(-1))
        np.testing.assert_array_equal(glabels.numpy(), want_labels)
        assert not bool(gcs.overflow)

    def test_trace_and_validation(self):
        cfg = tddc.DDCConfig(eps=0.05, min_pts=5, schedule="sync", max_clusters=8,
                             max_verts=32, grid=32)
        pts = tsp.make_blobs(256, 3, seed=1)[0]
        trace = {}
        run = tddc.make_ddc_fn(cfg, 4, device="cpu")
        run(torch.from_numpy(pts), torch.ones(256, dtype=torch.bool), trace)
        assert len(trace["results"]) == 4 and trace["batch"].valid.shape == (4, 8)
        assert trace["phase1_s"] >= 0 and trace["phase2_s"] >= 0
        with pytest.raises(ValueError):
            run(pts[:255], np.ones(255, bool))
        for bad, k in ((dict(schedule="async"), 3), (dict(schedule="async"), 6),
                       (dict(schedule="tree", tree_degree=1), 4),
                       (dict(local_algo="spectral"), 2), (dict(schedule="ring"), 2),
                       (dict(merge_refine="hull"), 2)):
            with pytest.raises(ValueError):
                tddc.make_ddc_fn(dataclasses.replace(cfg, **bad), k, device="cpu")
        # Every schedule, local algorithm and merge refinement runs, with
        # the reference's defaults among them.
        assert tddc.DDCConfig().schedule == "async"
        for good, k in ((dict(schedule="async"), 4), (dict(schedule="tree"), 2),
                        (dict(schedule="tree", tree_degree=3), 4),
                        (dict(local_algo="kmeans", kmeans_k=4), 2),
                        (dict(merge_refine="fps"), 2)):
            trace = {}
            glabels, gcs, _ = tddc.make_ddc_fn(dataclasses.replace(cfg, **good), k,
                                               device="cpu")(pts, np.ones(256, bool), trace)
            assert glabels.shape == (256,) and int(gcs.valid.sum()) >= 1
            assert trace["schedule"] == dataclasses.replace(cfg, **good).schedule
            assert trace["merge_calls"] >= 1


class TestHostOracle:
    def test_ddc_host_copy(self):
        pts = jsp.make_rings(1024)
        for contour in ("grid", "hull"):
            a, _, ea = jddc.ddc_host(pts, 4, 0.008, 5, contour=contour)
            b, _, eb = tddc.ddc_host(pts, 4, 0.008, 5, contour=contour)
            np.testing.assert_array_equal(a, b)
            assert ea == eb
        assert tddc.same_clustering(np.array([0, 0, 1, -1]), np.array([5, 5, 2, -1]))
        assert not tddc.same_clustering(np.array([0, 0, 1, -1]), np.array([5, 5, 5, -1]))


class TestGenerators:
    def test_generators_equal_reference(self):
        pairs = [
            (tsp.make_blobs(500, 6, seed=3)[0], jsp.make_blobs(500, 6, seed=3)[0]),
            (tsp.make_blobs(500, 6, seed=3)[1], jsp.make_blobs(500, 6, seed=3)[1]),
            (tsp.make_d1(3000), jsp.make_d1(3000)),
            (tsp.make_d2(3000), jsp.make_d2(3000)),
            (tsp.make_worm(700), jsp.make_worm(700)),
            (tsp.make_clustered(900, 5, seed=2), jsp.make_clustered(900, 5, seed=2)),
            (tsp.make_rings(2048), jsp.make_rings(2048)),
            (tsp.make_linked_ovals(2048), jsp.make_linked_ovals(2048)),
            (tsp.make_noise_heavy(2048), jsp.make_noise_heavy(2048)),
        ]
        for got, want in pairs:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert tsp.PHASE2_LAYOUTS.keys() == jsp.PHASE2_LAYOUTS.keys()
        for name, spec in tsp.PHASE2_LAYOUTS.items():
            ref_spec = jsp.PHASE2_LAYOUTS[name]
            assert {k: v for k, v in spec.items() if k != "make"} == \
                {k: v for k, v in ref_spec.items() if k != "make"}
            np.testing.assert_array_equal(spec["make"](1024), ref_spec["make"](1024))

    @pytest.mark.parametrize("bounds", [None, (0.0, 0.0, 1.0, 1.0), (-0.3, 0.1, 1.7, 0.9)])
    def test_morton_code_bit_for_bit(self, bounds):
        pts = np.concatenate([jsp.make_d2(4000, seed=5),
                              np.random.default_rng(1).uniform(-0.5, 1.5, (500, 2))
                              .astype(np.float32)])
        want = np.asarray(partitioner.morton_code(pts, bounds=bounds))
        got = tsp.morton_code(pts, bounds=bounds)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tsp.morton_sorted(pts), jsp.morton_sorted(pts))
