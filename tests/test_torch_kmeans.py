"""The port's K-Means path against the reference package's, on the CPU:
the plain version of the ``pairwise_dist_sq`` kernel, ``kmeans`` from
the reference's own initial centres, ``local_phase`` with
``local_algo="kmeans"``, the port's own k-means++ seeding, and the sync
pipeline with K-Means lanes.

The reference seeds from ``jax.random``, which PyTorch cannot reproduce,
so the tests draw the reference's centres with its own ``kmeanspp_init``
(jitted on its own, which gives the centres the jitted ``kmeans`` uses:
``test_reference_init_is_the_one_kmeans_uses``) and hand them to the port.

Tolerances: labels are held exactly.  Centroids are held to rtol 1e-6:
the reference sums each cluster in float32 (``onehot.T @ points``) in an
order of its own, the port in float64 rounded once, so a centroid may
differ by an ulp (about 6e-8 relative) per step, and 25 steps move it by
a few ulps at most (2.5e-7 at most on these inputs).  Inertia is held to
rtol 1e-4: d2 is the expansion |x|² + |c|² − 2x·c, so a centroid an ulp
off moves |c|² and with it every member's d2 by about 6e-8, all in the
same direction — 1.3e-5 of the inertia on the blob input.  The port's
inertia is also held exactly to its own d2, summed in float64 and rounded
once.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import ddc as jddc  # noqa: E402
from repro.core import kmeans as jkm  # noqa: E402
from repro.data import spatial as jsp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import ddc as tddc  # noqa: E402
from repro_torch.core import kmeans as tkm  # noqa: E402
from repro_torch.kernels import ops, pairwise_dist  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

CENTROID_RTOL = 1e-6
INERTIA_RTOL = 1e-4
KEY = jax.random.PRNGKey(0)
jit_init = jax.jit(jkm.kmeanspp_init, static_argnames=("k",))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))


def inputs(name):
    """Blob and clustered point sets, with a ragged mask, and their k."""
    rng = np.random.default_rng(len(name))
    if name == "blobs":
        pts = jsp.make_blobs(3000, 6, seed=4, spread=0.02)[0]
        k = 6
    elif name == "clustered":
        pts = jsp.make_clustered(4096, 8, seed=1)
        k = 8
    else:  # d2: the full-width path's data, at a lane's size
        pts = jsp.make_d2(32768, seed=1)[:4096]
        k = 8
    mask = rng.random(len(pts)) > 0.1
    return pts, mask, k


class TestPairwiseDistSq:
    @pytest.mark.parametrize("n,m", [(256, 8), (4096, 32), (1000, 7)])
    def test_plain_is_the_jitted_reference(self, n, m):
        """The plain version equals the jitted reference bit for bit over
        all n·m entries (XLA contracts |x|² and x·y into FMAs; the port
        computes those single roundings)."""
        rng = np.random.default_rng(n + m)
        x = rng.uniform(0, 1, (n, 2)).astype(np.float32)
        y = x[rng.choice(n, m, replace=False)] + rng.normal(0, 1e-3, (m, 2)).astype(np.float32)
        want = np.asarray(jax.jit(jref.pairwise_dist_sq)(jnp.asarray(x), jnp.asarray(y)))
        got = ops.pairwise_dist_sq(t(x), t(y))
        assert got.dtype == torch.float32 and got.shape == (n, m)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tref.pairwise_dist_sq(t(x), t(y)).numpy(), want)

    def test_first_lloyd_step_matches_inside_kmeans(self):
        """One step from the reference's centres: the assignment the port
        computes is the one the jitted kmeans computes."""
        pts, mask, k = inputs("d2")
        init = np.asarray(jit_init(KEY, jnp.asarray(pts), jnp.asarray(mask), k))
        one = jkm.kmeans(KEY, jnp.asarray(pts), jnp.asarray(mask), k, iters=1)
        got = tkm.kmeans(t(pts), t(mask), k, iters=1, init=t(init))
        want_labels = np.asarray(one.labels)
        np.testing.assert_array_equal(got.labels.numpy(), want_labels)
        np.testing.assert_allclose(got.centroids.numpy(), np.asarray(one.centroids),
                                   rtol=CENTROID_RTOL, atol=0)

    def test_only_two_dimensional_points(self):
        x = torch.zeros((8, 3))
        with pytest.raises(ValueError):
            tref.pairwise_dist_sq(x, x)
        with pytest.raises(ValueError):
            ops.pairwise_dist_sq(x, x)
        with pytest.raises(ValueError):
            pairwise_dist.pairwise_dist_sq(torch.zeros((8, 2)), torch.zeros((4, 3)))

    def test_dispatch_and_launch_count(self, monkeypatch):
        """CPU tensors take the plain version and count no launch; a CUDA
        tensor takes the kernel route (its checks replaced here to observe
        that without a card)."""
        x = torch.rand((16, 2))
        before = dict(ops.launch_counts())
        assert torch.equal(ops.pairwise_dist_sq(x, x[:3]), tref.pairwise_dist_sq(x, x[:3]))
        assert ops.launch_counts() == before and "pairwise_dist_sq" in before

        class FakeCudaTensor:
            device = torch.device("cuda")

        def kernel_route(*args):
            raise RuntimeError("kernel route")

        monkeypatch.setattr(pairwise_dist, "_check_points", kernel_route)
        with pytest.raises(RuntimeError, match="kernel route"):
            pairwise_dist.pairwise_dist_sq(FakeCudaTensor(), FakeCudaTensor())


class TestKMeans:
    def test_reference_init_is_the_one_kmeans_uses(self):
        """kmeanspp_init jitted on its own gives the centres the jitted
        kmeans starts from (kmeans with no Lloyd step returns them)."""
        pts, mask, k = inputs("clustered")
        sep = jit_init(KEY, jnp.asarray(pts), jnp.asarray(mask), k)
        inside = jkm.kmeans(KEY, jnp.asarray(pts), jnp.asarray(mask), k, iters=0)
        np.testing.assert_array_equal(np.asarray(sep), np.asarray(inside.centroids))

    @pytest.mark.parametrize("name", ["blobs", "clustered", "d2"])
    def test_equals_reference_from_its_centres(self, name):
        pts, mask, k = inputs(name)
        init = np.asarray(jit_init(KEY, jnp.asarray(pts), jnp.asarray(mask), k))
        want = jkm.kmeans(KEY, jnp.asarray(pts), jnp.asarray(mask), k)
        got = tkm.kmeans(t(pts), t(mask), k, init=t(init))
        assert got.labels.dtype == torch.int32 and got.centroids.dtype == torch.float32
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
        assert (got.labels.numpy()[~mask] == -1).all()
        np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids),
                                   rtol=CENTROID_RTOL, atol=0)
        np.testing.assert_allclose(float(got.inertia), float(want.inertia),
                                   rtol=INERTIA_RTOL)
        own = tref.pairwise_dist_sq(t(pts), got.centroids).amin(dim=1).double()
        assert float(got.inertia) == float(np.float32(own[t(mask)].sum()))

    def test_empty_cluster_keeps_its_centre(self):
        """A centre no point is nearest to stays where it is."""
        pts, mask, _ = inputs("blobs")
        init = np.array([[0.3, 0.3], [0.7, 0.7], [50.0, 50.0]], np.float32)
        got = tkm.kmeans(t(pts), t(mask), 3, init=t(init))
        np.testing.assert_array_equal(got.centroids.numpy()[2], init[2])
        assert not (got.labels.numpy() == 2).any()

    def test_masked_points_take_no_part(self):
        pts, mask, k = inputs("clustered")
        init = np.asarray(jit_init(KEY, jnp.asarray(pts), jnp.asarray(mask), k))
        moved = pts.copy()
        moved[~mask] = 7.0  # far away: would drag any centre they joined
        a = tkm.kmeans(t(pts), t(mask), k, init=t(init))
        b = tkm.kmeans(t(moved), t(mask), k, init=t(init))
        assert all(torch.equal(x, y) for x, y in zip(a, b))


class TestSeeding:
    def test_deterministic_for_a_seed(self):
        pts, mask, k = inputs("clustered")
        x, m = t(pts), t(mask)

        def draw(seed):
            return tkm.kmeanspp_init(x, m, k, torch.Generator().manual_seed(seed))

        assert torch.equal(draw(3), draw(3))
        assert not torch.equal(draw(3), draw(4))
        a = tkm.kmeans(x, m, k, generator=torch.Generator().manual_seed(5))
        b = tkm.kmeans(x, m, k, generator=torch.Generator().manual_seed(5))
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        assert torch.equal(tkm.kmeans(x, m, k).centroids,
                           tkm.kmeans(x, m, k, generator=torch.Generator().manual_seed(0))
                           .centroids)

    def test_picks_are_masked_points(self):
        pts, mask, k = inputs("blobs")
        valid = {tuple(p) for p in pts[mask].tolist()}
        for seed in range(20):
            cents = tkm.kmeanspp_init(t(pts), t(mask), k, torch.Generator().manual_seed(seed))
            assert all(tuple(c) in valid for c in cents.numpy().tolist())

    def test_picks_follow_d2(self):
        """The first pick is uniform over the masked points and the second
        ∝ its squared distance to the first: observed pair frequencies
        within 4.5 standard deviations of the expected ones."""
        pts = np.array([[0, 0], [1, 0], [0, 2], [3, 3], [0.5, 0.5], [9, 9]], np.float32)
        mask = np.array([True, True, True, True, True, False])
        valid = np.flatnonzero(mask)
        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1) * mask[None, :]
        expected = np.zeros((6, 6))
        for i in valid:
            expected[i] = d2[i] / d2[i].sum() / len(valid)
        draws = 6000
        counts = np.zeros((6, 6))
        gen = torch.Generator().manual_seed(11)
        where = {tuple(p): i for i, p in enumerate(pts.tolist())}
        for _ in range(draws):
            c = tkm.kmeanspp_init(t(pts), t(mask), 2, gen).numpy().tolist()
            counts[where[tuple(c[0])], where[tuple(c[1])]] += 1
        p = counts / draws
        sd = np.sqrt(expected * (1 - expected) / draws)
        assert counts[~mask].sum() == 0 and counts[:, ~mask].sum() == 0
        assert (np.abs(p - expected) <= 4.5 * sd + 1e-12).all(), (p, expected)


def jstack(sets):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *sets)


def assert_same_set(t_cs, j_cs):
    for f in tddc.ClusterSet._fields:
        got, want = getattr(t_cs, f), np.asarray(getattr(j_cs, f))
        assert got.numpy().dtype == want.dtype, f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


KM_J = jddc.DDCConfig(eps=0.02, local_algo="kmeans", kmeans_k=6, max_clusters=8,
                      max_verts=64, grid=64, schedule="sync")
KM_T = tddc.DDCConfig.from_dict(dataclasses.asdict(KM_J))


class TestLocalPhase:
    @pytest.mark.parametrize("name", ["blobs", "clustered"])
    def test_clusterset_equals_reference(self, name):
        pts, mask, _ = inputs(name)
        k = min(KM_J.kmeans_k, KM_J.max_clusters)
        init = np.asarray(jit_init(KEY, jnp.asarray(pts), jnp.asarray(mask), k))
        jd, jc = jddc.local_phase(jnp.asarray(pts), jnp.asarray(mask), KM_J)
        td, tc = tddc.local_phase(t(pts), t(mask), KM_T, init=t(init))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert_same_set(tc, jc)

    def test_budget_caps_k(self):
        """k = min(kmeans_k, max_clusters): never an overflow."""
        pts, mask, _ = inputs("clustered")
        cfg = dataclasses.replace(KM_T, kmeans_k=12, max_clusters=4)
        dense, cs = tddc.local_phase(t(pts), t(mask), cfg, seed=2)
        assert int(dense.max()) <= 3 and not bool(cs.overflow)
        assert int(cs.valid.sum()) == 4

    def test_sync_pipeline_equals_reference_lanes(self):
        """make_ddc_fn with K-Means lanes (sync) equals the reference's
        local_phase per lane, merge_many and merge_sync's lookup, each lane
        from the reference's centres (every lane seeds from PRNGKey(0))."""
        pts = jsp.make_blobs(2048, 5, seed=6, spread=0.015)[0]
        k_lanes, per = 4, 512
        k = min(KM_J.kmeans_k, KM_J.max_clusters)
        lanes, inits = [], []
        for i in range(k_lanes):
            lp = jnp.asarray(pts[i * per:(i + 1) * per])
            inits.append(np.asarray(jit_init(KEY, lp, jnp.ones(per, bool), k)))
            lanes.append(jddc.local_phase(lp, jnp.ones(per, bool), KM_J))
        batch = jstack([cs for _, cs in lanes])
        _, maps = jddc.merge_many(batch, KM_J)
        my_map = jnp.where(batch.valid, maps, -1)
        want = np.concatenate([np.asarray(jnp.where(d >= 0, my_map[i][jnp.clip(d, 0)], -1))
                               for i, (d, _) in enumerate(lanes)])
        trace = {}
        glabels, gcs, t_map = tddc.make_ddc_fn(KM_T, k_lanes, device="cpu",
                                               init=np.stack(inits))(
            pts, np.ones(len(pts), bool), trace)
        np.testing.assert_array_equal(t_map.numpy(), np.asarray(my_map).reshape(-1))
        np.testing.assert_array_equal(glabels.numpy(), want)
        assert [p["path"] for p in trace["paths"]] == ["kmeans"] * k_lanes
        assert trace["merge_calls"] == 1
