"""The port's grid contours against the reference package's, bit for bit,
on the tests/test_geometry*.py inputs.  The reference runs under ``jit``,
as it does on the main path (local_phase and the merge), where its
division by the constant raster scale compiles to a multiply by the
reciprocal fused with the add."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import geometry as jG  # noqa: E402
from repro_torch.core import geometry as tG  # noqa: E402

BOUNDS = (0.0, 0.0, 1.0, 1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _jitted(bounds, grid, max_verts):
    def f(p, m):
        occ = jG.grid_occupancy(p, m, bounds, grid)
        bnd = jG.grid_boundary(occ)
        pts, cnt = jG.cells_to_points(bnd, bounds, max_verts)
        return occ, bnd, pts, cnt
    return jax.jit(f)


def check_same(pts, mask, bounds, grid, max_verts):
    occ, bnd, cpts, cnt = _jitted(bounds, grid, max_verts)(jnp.asarray(pts), jnp.asarray(mask))
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    t_occ = tG.grid_occupancy(tp, tm, bounds, grid)
    t_bnd = tG.grid_boundary(t_occ)
    t_pts, t_cnt = tG.cells_to_points(t_bnd, bounds, max_verts)
    np.testing.assert_array_equal(t_occ.numpy(), np.asarray(occ))
    np.testing.assert_array_equal(t_bnd.numpy(), np.asarray(bnd))
    np.testing.assert_array_equal(t_pts.numpy(), np.asarray(cpts))
    assert t_cnt.dtype == torch.int32 and int(t_cnt) == int(cnt)
    e_pts, e_cnt = tG.extract_contour(tp, tm, bounds, grid, max_verts)
    np.testing.assert_array_equal(e_pts.numpy(), np.asarray(cpts))
    assert int(e_cnt) == int(cnt)


def _lattice(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 2)) / 256.0).astype(np.float32)


def test_ring_square():
    pts = np.random.default_rng(0).uniform(0.3, 0.7, (4000, 2)).astype(np.float32)
    check_same(pts, np.ones(len(pts), bool), BOUNDS, 32, 256)


def test_matches_np_oracle_input():
    pts = np.random.default_rng(1).uniform(0.2, 0.5, (500, 2)).astype(np.float32)
    check_same(pts, np.ones(len(pts), bool), BOUNDS, 32, 512)
    _, cnt = tG.extract_contour(torch.from_numpy(pts), torch.ones(500, dtype=torch.bool),
                                BOUNDS, 32, 512)
    assert int(cnt) == len(tG.grid_contour_np(pts, BOUNDS, 32))


def test_mask_respected():
    pts = np.array([[0.1, 0.1], [0.9, 0.9]], np.float32)
    check_same(pts, np.array([True, False]), BOUNDS, 16, 8)


@pytest.mark.parametrize("grid", (17, 33, 65))
@pytest.mark.parametrize("shift", [(0.0, 0.0), (-2.0, 3.5), (0.25, -0.5), (1.0, 0.5)])
def test_translated_bounds(grid, shift):
    tx, ty = shift
    pts = _lattice(grid, 200) + np.float32([tx, ty])
    mask = np.random.default_rng(grid).random(200) > 0.2
    check_same(pts, mask, (tx, ty, 1.0 + tx, 1.0 + ty), grid, 64)


@pytest.mark.parametrize("s", (0.5, 2.0, 4.0))
@pytest.mark.parametrize("max_verts", (8, 32, 128))
def test_scaled_bounds_and_budget(s, max_verts):
    pts = _lattice(int(s * 10) + max_verts, 250) * np.float32(s)
    check_same(pts, np.ones(len(pts), bool), (0.0, 0.0, s, s), 33, max_verts)


@pytest.mark.parametrize("grid,bounds", [(48, (0.1, 0.2, 0.9, 0.7)),
                                         (128, (-0.5, 0.25, 1.5, 3.5)), (96, BOUNDS)])
def test_uneven_bounds(grid, bounds):
    rng = np.random.default_rng(grid)
    pts = np.stack([rng.uniform(bounds[0], bounds[2], 400),
                    rng.uniform(bounds[1], bounds[3], 400)], -1).astype(np.float32)
    check_same(pts, rng.random(400) > 0.1, bounds, grid, 96)


def test_batched_slots_equal_one_at_a_time():
    """A (S, n) mask gives S contours, each the one the reference's vmap
    body extracts for its slot."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1, (600, 2)).astype(np.float32)
    slot = rng.integers(-1, 5, 600)
    masks = slot[None, :] == np.arange(5)[:, None]
    f = jax.jit(jax.vmap(lambda m: jG.extract_contour(jnp.asarray(pts), m, BOUNDS, 48, 40)))
    want_pts, want_cnt = f(jnp.asarray(masks))
    got_pts, got_cnt = tG.extract_contour(torch.from_numpy(pts), torch.from_numpy(masks),
                                          BOUNDS, 48, 40)
    np.testing.assert_array_equal(got_pts.numpy(), np.asarray(want_pts))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))


def test_vert_validity():
    counts = np.array([0, 3, 8, 11], np.int32)
    valid = np.array([True, True, False, True])
    np.testing.assert_array_equal(
        tG.vert_validity(torch.from_numpy(counts), torch.from_numpy(valid), 8).numpy(),
        np.asarray(jG.vert_validity(jnp.asarray(counts), jnp.asarray(valid), 8)))


@pytest.mark.parametrize("seed", range(3))
def test_numpy_oracle_copies(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (40, 2))
    b = a[:20] + rng.uniform(-0.3, 0.6, 2)
    np.testing.assert_array_equal(tG.convex_hull_np(a), jG.convex_hull_np(a))
    ha, hb = tG.convex_hull_np(a), tG.convex_hull_np(b)
    q = rng.uniform(0, 1, (50, 2))
    np.testing.assert_array_equal(tG.point_in_polygon_np(q, ha), jG.point_in_polygon_np(q, ha))
    assert tG.polygons_overlap_np(ha, hb) == jG.polygons_overlap_np(ha, hb)
    assert tG._segments_intersect_np(a[0], a[1], a[2], a[3]) == \
        jG._segments_intersect_np(a[0], a[1], a[2], a[3])
    np.testing.assert_array_equal(tG.grid_contour_np(a, BOUNDS, 16),
                                  jG.grid_contour_np(a, BOUNDS, 16))


def _hull_inputs():
    """The reference test's quantised inputs (tests/test_geometry.py:45),
    raw uniform ones, near-collinear ones (points on a line nudged by
    1e-7, where the FMA in the cross product decides), 4 to 24 points
    unmasked of 24 (one shape, so the eager reference compiles once), and
    nothing unmasked."""
    rng = np.random.default_rng(11)
    out = []
    for n in (4, 9, 16, 24):
        line = rng.uniform(0, 1, 24)
        for pts in (np.round(rng.uniform(0, 1, (24, 2)), 2), rng.uniform(0, 1, (24, 2)),
                    np.stack([line, 0.3 + 0.7 * line], -1) + rng.normal(0, 1e-7, (24, 2))):
            out.append((pts, (np.arange(24) < n) & (rng.random(24) > 0.1)))
    out.append((np.zeros((24, 2)), np.zeros(24, bool)))
    return [(p.astype(np.float32), m) for p, m in out]


@pytest.mark.parametrize("case", range(13))
def test_convex_hull_torch_equals_reference(case):
    """convex_hull_torch against convex_hull_jax called as the reference's
    own test calls it (eagerly, max_verts 70): hull rows and count bit for
    bit.  The cross product matched only as fma(ax, by, −(ay·bx)) (the
    FMA-free form and fma(−ay, bx, ax·by) lose near-collinear cases); the
    squared distance decides only among collinear candidates, where every
    form gives the same bits."""
    pts, mask = _hull_inputs()[case]
    want, want_n = jG.convex_hull_jax(jnp.asarray(pts), jnp.asarray(mask), max_verts=70)
    got, got_n = tG.convex_hull_torch(torch.from_numpy(pts), torch.from_numpy(mask), 70)
    assert got.dtype == torch.float32 and got_n.dtype == torch.int32
    assert int(got_n) == int(want_n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _within_or_inside(pts, poly, tol):
    """Every point inside ``poly`` or within ``tol`` of one of its edges."""
    a, b = poly, np.roll(poly, -1, axis=0)
    ab = b - a
    t = np.clip(((pts[:, None, :] - a) * ab).sum(-1) / np.maximum((ab * ab).sum(-1), 1e-300),
                0, 1)
    near = np.linalg.norm(a + t[..., None] * ab - pts[:, None, :], axis=-1).min(1) <= tol
    return near | tG.point_in_polygon_np(pts, poly)


def test_pinned_thin_triangle_hull():
    """The input on which tests/test_geometry.py's hull property test
    fails now and then: a thin triangle with a duplicate point.  Both
    packages' hulls are the three distinct points, bit for bit; the
    reference test's inflated-polygon check puts the two outer vertices
    outside (its boundary rule is at fault, not the hull), and a
    boundary-aware check holds."""
    pts = np.array([[0.0, 0.23828125], [0.375, 0.1328125], [0.1875, 0.1875],
                    [0.1875, 0.1875]])
    hull = tG.convex_hull_np(pts)
    np.testing.assert_array_equal(hull, jG.convex_hull_np(pts))
    assert {tuple(p) for p in hull} == {tuple(p) for p in pts}
    centroid = hull.mean(0)
    big = centroid + (hull - centroid) * (1 + 1e-6) + 1e-9
    np.testing.assert_array_equal(tG.point_in_polygon_np(pts, big),
                                  [False, False, True, True])
    assert _within_or_inside(pts, hull, 1e-9).all()
    p32 = pts.astype(np.float32)
    want, want_n = jG.convex_hull_jax(jnp.asarray(p32), jnp.ones(4, bool), max_verts=70)
    got, got_n = tG.convex_hull_torch(torch.from_numpy(p32), torch.ones(4, dtype=torch.bool), 70)
    assert int(got_n) == int(want_n) == 3
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(3))
def test_min_cross_distance_sq_equals_reference(seed):
    """Against the jitted reference, counts from none to all rows, on 100
    small draws: XLA:CPU contracts ``sum((a − b) ** 2, -1)`` under jit
    into fma(dy, dy, dx·dx), and the port computes that.  The eager
    reference (one op at a time) is FMA-free and differs on some draws,
    as the FMA-free form does from the jitted one."""
    rng = np.random.default_rng(seed)
    f = jax.jit(jG.min_cross_distance_sq)
    fma_free_differs = 0
    for draw in range(100):
        a = rng.uniform(0, 1, (6, 2)).astype(np.float32)
        b = rng.uniform(0, 1, (5, 2)).astype(np.float32)
        na, nb = ((6, 5), (2, 3), (0, 5), (1, 1))[draw % 4]
        want = f(jnp.asarray(a), jnp.int32(na), jnp.asarray(b), jnp.int32(nb))
        got = tG.min_cross_distance_sq(torch.from_numpy(a), torch.tensor(na, dtype=torch.int32),
                                       torch.from_numpy(b), torch.tensor(nb, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert got.item() == float(want), (draw, na, nb)
        d = a[:na, None] - b[None, :nb]
        if na and nb:
            fma_free_differs += float((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]).min()) \
                != float(want)
    assert fma_free_differs > 0
