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
