"""The schedule of the neighbour-count kernels that test each unordered
pair once (``src/repro_torch/kernels/csrc/pair_sweep.cu``: B1
``neighbor_count`` and B3 ``neighbor_count_sparse``), held on the CPU,
where no kernel runs.

The counts share the min-label sweeps' work items and pair test
(``tests/test_torch_sweep_sym.py`` holds the test symmetric, the active
set symmetric, and the fold exact within 2^62).  A sum, unlike a min,
counts a pair again if it is met again, so the cover must be exact: an
off-diagonal item {A, B} feeds A's rows and B's rows from the same tests,
and a diagonal item feeds only its rows, from its S × S ordered tests.
That cover is checked here, pair by pair, and an emulation of the
kernels' schedule — the items as the CUDA source decodes them, the
per-item choice of the fold (every coordinate within 2^62) or the exact
path, both directions off the diagonal, rows only on it, masked-out rows
never written, and integer adds merged in a shuffled item order — is held
bit for bit to the port's plain versions, to ``repro.kernels.ref`` and to
the interpret-mode Pallas kernels.  Everything is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import pairwise_dist as jpd  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import dbscan as tdb  # noqa: E402
from repro_torch.kernels import ops, pairwise_dist  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_blocksparse import make_layout  # noqa: E402
from test_torch_sweep_sym import FOLD_BOUND, dense_items, fold_d2, sparse_items  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))


def fast_item(x, ia, ib) -> bool:
    """pair_sweep.cu's per-item choice for the count: the fold wherever
    every coordinate of both tiles lies within 2^62 (not NaN)."""
    return bool((torch.cat([x[ia], x[ib]]).abs() <= float(FOLD_BOUND)).all())


def emulate(x, mask, eps, items, size, seed, path_counts=None):
    """The count kernels' result: the output starts at 0; for each item
    {A, B} in a shuffled order, every pair of A × B tested once, on the
    fold or the exact path (s - 2·dot, each direction on its own), w =
    mask ? 1 : 0 summed into A's rows and, off the diagonal, B's rows; a
    masked-out row is never written."""
    n = x.shape[0]
    x = x.to(torch.float32)
    xx = tref._sqnorm(x)
    w = mask.to(torch.int32)
    e = torch.tensor(tref.eps_sq_f32(eps), dtype=torch.float32)
    out = torch.zeros((n,), dtype=torch.int32)
    rng = np.random.default_rng(seed)

    def sums(ia, ib, fast):
        if fast:
            ok = fold_d2(x[ia], xx[ia], x[ib], xx[ib]) <= e
            return (torch.where(ok, w[ib][None, :], 0).sum(dim=1, dtype=torch.int32),
                    torch.where(ok, w[ia][:, None], 0).sum(dim=0, dtype=torch.int32))
        ok_r = tref._d2_rows(x[ia], xx[ia], x[ib], xx[ib]) <= e
        ok_c = tref._d2_rows(x[ib], xx[ib], x[ia], xx[ia]) <= e
        return (torch.where(ok_r, w[ib][None, :], 0).sum(dim=1, dtype=torch.int32),
                torch.where(ok_c, w[ia][None, :], 0).sum(dim=1, dtype=torch.int32))

    def commit(idx, v):
        out[idx] += torch.where(mask[idx], v, 0)

    for q in rng.permutation(len(items)):
        a0, b0 = items[q]
        ia, ib = torch.arange(a0, min(a0 + size, n)), torch.arange(b0, min(b0 + size, n))
        fast = fast_item(x, ia, ib)
        if path_counts is not None:
            path_counts["fast" if fast else "exact"] += 1
        rows, cols = sums(ia, ib, fast)
        commit(ia, rows)
        if a0 != b0:
            commit(ib, cols)
    return out


def hits_per_pair(items, size, n) -> torch.Tensor:
    """(n, n): how often the items' tests add to row i for column j —
    both directions off the diagonal, rows only on it."""
    hits = torch.zeros((n, n), dtype=torch.int8)
    for a0, b0 in items:
        ia, ib = slice(a0, min(a0 + size, n)), slice(b0, min(b0 + size, n))
        hits[ia, ib] += 1
        if a0 != b0:
            hits[ib, ia] += 1
    return hits


# -- the cover ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 255, 256, 257, 600, 1537])
def test_dense_items_count_each_ordered_pair_once(n):
    items, size = dense_items(n)
    assert len(items) == pairwise_dist.sym_work_items(n)
    assert bool((hits_per_pair(items, size, n) == 1).all())


def _sorted(layout: str, n: int, bt: int, seed: int, empty_tile: bool):
    """test_torch_blocksparse.py's layouts (and "duplicates": 16 copies of
    each point), about 15 % of the rows masked, spatially sorted."""
    rng = np.random.default_rng(seed)
    if layout == "duplicates":
        pts = make_layout("clustered", n // 16, seed).repeat(16, axis=0)
    else:
        pts = make_layout(layout, n, seed)
    mask = rng.random(n) > 0.15
    if empty_tile:
        mask[-bt:] = False  # after the sort, the last tile holds only masked rows
    x, m = t(pts), t(mask)
    sp, sm, _ = tdb.spatial_sort(tdb.center_points(x, m), m, bt)
    return sp.contiguous(), sm.contiguous()


# (layout, n, bt, eps, empty_tile): test_torch_blocksparse.py's SPARSE_CASES
# at bt 64, then sub-tiles of 32 (bt 96), 128 and 512 (two sub-tiles of 256
# a tile), duplicate points and empty tiles.
SPARSE_CASES = [("random", 384, 64, 0.03, False), ("random", 384, 64, 0.1, True),
                ("clustered", 384, 64, 0.03, True), ("clustered", 384, 64, 0.1, False),
                ("one_cell", 384, 64, 0.03, False), ("duplicates", 384, 64, 0.05, False),
                ("clustered", 2048, 96, 0.05, True), ("random", 2048, 96, 0.05, False),
                ("clustered", 4096, 128, 0.03, True), ("one_cell", 2048, 128, 0.01, False),
                ("random", 4096, 512, 0.02, False), ("duplicates", 4096, 512, 0.01, True)]


@pytest.mark.parametrize("layout,n,bt,eps,empty_tile", SPARSE_CASES)
def test_sparse_items_count_each_active_ordered_pair_once(layout, n, bt, eps, empty_tile):
    sp, sm = _sorted(layout, n, bt, n + bt, empty_tile)
    p = ops.build_tile_pairs(sp, sm, eps, bt=bt)
    npad = sp.shape[0]
    items, size = sparse_items(p, npad, bt)
    assert len(items) == pairwise_dist.sym_work_items(npad, p, bt=bt)
    na = int(p.n_active)
    active = torch.zeros((npad // bt, npad // bt), dtype=torch.int8)
    active[p.rows[:na].long(), p.cols[:na].long()] = 1
    want = active.repeat_interleave(bt, dim=0).repeat_interleave(bt, dim=1)
    assert torch.equal(hits_per_pair(items, size, npad), want)


# -- the schedule against the references ------------------------------------------------

def _count_inputs(n, seed, kind):
    """Points and mask.  ``kind``: "normal" (about 30 % masked out);
    "all_masked" (no row takes part); "duplicates" (16 copies of each
    point); "overflow" (coordinates up to about 4e17, within 2^62, but for
    point 3 at 1.35e19, whose |x|² doubled overflows: with eps² = inf the
    plain test gives NaN for it against itself and the fold inf, so its
    items must take the exact path)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2)).astype(np.float32)
    mask = rng.random(n) > (1.1 if kind == "all_masked" else 0.3)
    if kind == "duplicates":
        x = x[:n // 16].repeat(16, axis=0)
    elif kind == "overflow":
        x = (x * np.float32(1e17)).astype(np.float32)
        x[3] = (1.35e19, 0.0)
        mask[3] = True
    return x, mask


# n = 1, tests/test_torch_kernels.py's n = 256, ragged n, several tiles, all
# rows masked, duplicates, and coordinates beyond the fold's bound.
DENSE_CASES = [(1, 0.1, "normal"), (256, 0.5, "normal"), (300, 0.25, "normal"),
               (512, 0.2, "duplicates"), (1000, 0.1, "normal"), (1537, 0.08, "normal"),
               (700, 0.3, "all_masked"), (2048, 0.05, "duplicates"), (600, 1e20, "overflow")]


@pytest.mark.filterwarnings("ignore:overflow encountered")  # eps² of 1e20 is inf
@pytest.mark.parametrize("n,eps,kind", DENSE_CASES)
def test_dense_count_schedule_equals_the_references(n, eps, kind):
    x, mask = _count_inputs(n, n + 23, kind)
    items, size = dense_items(n)
    paths = {"fast": 0, "exact": 0}
    got = emulate(t(x), t(mask), eps, items, size, seed=n, path_counts=paths)
    want = tref.neighbor_count(t(x), t(mask), eps)
    assert torch.equal(got, want)
    jx, jm = jnp.asarray(x), jnp.asarray(mask)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.neighbor_count(jx, jm, jnp.float32(eps))))
    if kind == "overflow":
        assert paths["exact"] == 3  # the first tile's three items
        assert int(got[3]) == int(mask.sum()) - 1  # all but itself: its plain d2 is NaN
    else:
        assert paths == {"fast": len(items), "exact": 0}
    if kind == "all_masked":
        assert not bool(got.any())
    if n <= 512 or n % 512 == 0:  # the Pallas kernel's tiles must divide n
        pallas = jpd.neighbor_count(jx, jm, jnp.float32(eps), interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("layout,n,bt,eps,empty_tile", SPARSE_CASES)
def test_sparse_count_schedule_equals_the_references(layout, n, bt, eps, empty_tile):
    sp, sm = _sorted(layout, n, bt, n + bt + 1, empty_tile)
    npad = sp.shape[0]
    p = ops.build_tile_pairs(sp, sm, eps, bt=bt)
    items, size = sparse_items(p, npad, bt)
    got = emulate(sp, sm, eps, items, size, seed=npad)
    want = tref.neighbor_count_sparse(sp, sm, eps, p.rows, p.cols, p.flags, bt)
    assert torch.equal(got, want)
    assert torch.equal(got, tref.neighbor_count(sp, sm, eps))  # B3 == B1
    jsp, jsm = jnp.asarray(sp.numpy()), jnp.asarray(sm.numpy())
    jp = tuple(jnp.asarray(v.numpy()) for v in (p.rows, p.cols, p.flags))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.neighbor_count_sparse(jsp, jsm, eps, *jp, bt)))
    if bt == 64:
        pallas = jpd.neighbor_count_sparse(jsp, jsm, eps, *jp, bt=bt, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.filterwarnings("ignore:overflow encountered")  # eps² of 1e20 is inf
def test_sparse_count_schedule_beyond_the_fold_bound():
    """A point list the wrapper accepts whose first tile holds a point
    beyond 2^62: at eps² = inf every tile pair is active, the first
    tile's items take the exact path, and the count equals the plain
    versions and the reference's dense count (the point does not count
    itself: its plain d2 is NaN).  The reference's sparse count, as
    XLA:CPU compiles it, contracts that test into fma(-2, dot, s) = inf
    and counts the point itself, unlike its own dense count (ROADMAP C);
    the port follows the dense one."""
    x, mask = _count_inputs(384, 7, "overflow")
    sp, sm = t(x), t(mask)
    p = ops.build_tile_pairs(sp, sm, 1e20, bt=64)
    assert int(p.n_active) == 36
    items, size = sparse_items(p, 384, 64)
    paths = {"fast": 0, "exact": 0}
    got = emulate(sp, sm, 1e20, items, size, seed=3, path_counts=paths)
    assert paths["exact"] == 6  # tile 0 with itself and with the five others
    want = tref.neighbor_count_sparse(sp, sm, 1e20, p.rows, p.cols, p.flags, 64)
    assert torch.equal(got, want) and torch.equal(got, tref.neighbor_count(sp, sm, 1e20))
    assert int(got[3]) == int(sm.sum()) - 1
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.neighbor_count(jnp.asarray(x), jnp.asarray(mask),
                                                    jnp.float32(1e20))))


def test_cpu_count_wrappers_take_the_plain_versions():
    """On CPU tensors the wrappers run the plain versions and count no
    launch, with or without the upper list (the CPU path reads the
    row-major list)."""
    sp, sm = _sorted("clustered", 384, 64, 5, False)
    p = ops.build_tile_pairs(sp, sm, 0.05, bt=64)
    ops.reset_launch_counts()
    assert torch.equal(pairwise_dist.neighbor_count(sp, sm, 0.05),
                       tref.neighbor_count(sp, sm, 0.05))
    old = p._replace(up_rows=None, up_cols=None, n_up=None)
    assert torch.equal(pairwise_dist.neighbor_count_sparse(sp, sm, 0.05, old, bt=64),
                       tref.neighbor_count(sp, sm, 0.05))
    assert pairwise_dist.launches["neighbor_count"] == 0
    assert pairwise_dist.launches["neighbor_count_sparse"] == 0
