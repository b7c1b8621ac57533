"""The arithmetic of the min-label sweep kernels that test each unordered
pair once (``src/repro_torch/kernels/csrc/pair_sweep.cu``: B2
``min_label_sweep`` and B4 ``min_label_sweep_sparse``), held on the CPU,
where no kernel runs.

The kernels test each unordered pair of points once and fold the result
into both rows, with integer mins merged in any order.  That is exact only
if (1) the pair test gives the same float32 bits both ways round, (2) the
active tile-pair set is symmetric, so its upper half and the diagonal
cover every active pair once, and (3) the folded form d2 = fma(-2, dot, s)
is s - 2·dot bit for bit wherever the kernel uses it (every coordinate of
the item within 2^62).  Those are checked here, and then an emulation of
the kernels' schedule — their work items as the CUDA source decodes them
(transcribed below), the per-item choice of the fast path (predicated mins
from 2^30) or the exact path, both directions of each test, the output's
start value, and min-merging in a shuffled item order — is held bit for
bit to the
port's plain versions, to ``repro.kernels.ref`` and to the interpret-mode
Pallas kernels, labels above 2^30 included.  Everything is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import pairwise_dist as jpd  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import dbscan as tdb  # noqa: E402
from repro_torch.data import spatial  # noqa: E402
from repro_torch.kernels import ops, pairwise_dist  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SENT = tref.SENTINEL
NONE = pairwise_dist.INT32_MAX
FOLD_BOUND = np.float32(2.0 ** 62)  # pair_sweep.cu kFoldBound


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))


def bits(v: torch.Tensor) -> torch.Tensor:
    return v.contiguous().view(torch.int32)


def fold_d2(x: torch.Tensor, xx: torch.Tensor, y: torch.Tensor, yy: torch.Tensor):
    """The kernels' fast-path test: fma(-2, fma(x1, y1, x0·y0), xx + yy)."""
    dot = tref.fma_f32(x[:, None, 1], y[None, :, 1], x[:, None, 0] * y[None, :, 0])
    return tref.fma_f32(torch.tensor(-2.0), dot, xx[:, None] + yy[None, :])


# -- (1) the pair test is symmetric --------------------------------------------

def _points(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.normal(size=(n, 2)).astype(np.float32)
    if kind == "clustered":
        return spatial.make_clustered(n, seed=seed) - np.float32(0.5)
    # duplicates: a few distinct points, each repeated many times
    return rng.normal(size=(n // 16, 2)).astype(np.float32).repeat(16, axis=0)


@pytest.mark.parametrize("kind", ["random", "clustered", "duplicates"])
@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e3, 1e-20, 2e19])
def test_pair_d2_is_symmetric(kind, scale):
    """d2(i, j) and d2(j, i) are the same float32 bits: each product, the
    FMA and the sum commute and round once — on points of largest |x_k| =
    ``scale``: at 1e-20 the products are subnormal, at 2e19 |x|² and the
    dot overflow (inf, NaN)."""
    pts = _points(kind, 768, 3)
    x = t((pts / np.abs(pts).max() * np.float32(scale)).astype(np.float32))
    xx = tref._sqnorm(x)
    d2 = tref._d2_rows(x, xx, x, xx)
    assert torch.equal(bits(d2), bits(d2.T))
    if scale == 2e19:
        assert bool(torch.isinf(xx).any()) and bool(torch.isnan(d2).any())


# -- (2) the active set is symmetric; the upper list --------------------------------

def _sorted(layout: str, n: int, bt: int, seed: int, empty_tile: bool):
    rng = np.random.default_rng(seed)
    if layout == "one_cell":
        pts = (0.5 + rng.normal(0, 0.001, (n, 2))).astype(np.float32)
    elif layout == "clustered":
        pts = spatial.make_clustered(n, seed=seed)
    else:
        pts = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    mask = rng.random(n) > (0.02 if layout == "one_cell" else 0.2)
    if empty_tile:
        mask[-bt:] = False  # after the sort, the last tile holds only masked rows
    x, m = t(pts), t(mask)
    sp, sm, _ = tdb.spatial_sort(tdb.center_points(x, m), m, bt)
    return sp.contiguous(), sm.contiguous()


# tests/test_torch_gpu.py's SPARSE_CASES and tests/test_torch_blocksparse.py's layouts
PAIR_CASES = [("clustered", 4096, 64, 0.02, False), ("clustered", 4096, 128, 0.03, True),
              ("random", 8192, 512, 0.01, False), ("clustered", 32768, 512, 0.005, True),
              ("one_cell", 2048, 128, 0.01, False), ("random", 1000, 64, 0.05, True),
              ("random", 384, 64, 0.1, True), ("clustered", 384, 64, 0.03, False),
              ("one_cell", 384, 64, 0.03, False), ("random", 512, 512, 0.1, False)]


def _active(p, tiles: int) -> torch.Tensor:
    na = int(p.n_active)
    a = torch.zeros((tiles, tiles), dtype=torch.bool)
    a[p.rows[:na].long(), p.cols[:na].long()] = True
    return a


@pytest.mark.parametrize("layout,n,bt,eps,empty_tile", PAIR_CASES)
def test_active_set_is_symmetric_and_upper_list(layout, n, bt, eps, empty_tile):
    sp, sm = _sorted(layout, n, bt, n + bt, empty_tile)
    p = ops.build_tile_pairs(sp, sm, eps, bt=bt)
    tiles = sp.shape[0] // bt
    a = _active(p, tiles)
    assert torch.equal(a, a.T)
    assert bool(a.diagonal().all())
    # The upper list: the active pairs I < J first, in row-major order, then
    # every other pair I < J once; the diagonal is implicit.
    n_up = int(p.n_up)
    assert n_up * 2 + tiles == int(p.n_active)
    want = torch.triu(a, 1).nonzero()
    assert torch.equal(p.up_rows[:n_up].long(), want[:, 0])
    assert torch.equal(p.up_cols[:n_up].long(), want[:, 1])
    every = p.up_rows.long() * tiles + p.up_cols.long()
    iu = torch.triu_indices(tiles, tiles, 1)
    assert torch.equal(every.sort().values, (iu[0] * tiles + iu[1]).sort().values)
    assert not bool(a[p.up_rows[n_up:].long(), p.up_cols[n_up:].long()].any())
    assert p.up_rows.dtype == p.up_cols.dtype == p.n_up.dtype == torch.int32


# -- (3) d2 = fma(-2, dot, s) --------------------------------------------------------

def _edge_operands():
    """s >= 0 (a sum of squared norms) and dot of either sign, over every
    magnitude class: zero, subnormal, normal, near and at FLT_MAX, inf."""
    rng = np.random.default_rng(5)
    f32 = np.finfo(np.float32)
    mags = np.array([0.0, 1e-45, 3e-42, 1e-40, f32.tiny, 1e-20, 1e-3, 1.0, 1e3, 1e19, 1e38,
                     1.7e38, 2.0 ** 127, f32.max / 2, f32.max, np.inf], dtype=np.float32)
    rand = (rng.uniform(1, 2, 4000) * 2.0 ** rng.integers(-150, 128, 4000)).astype(np.float32)
    vals = np.concatenate([mags, np.nextafter(mags, np.float32(0)), rand]).astype(np.float32)
    s = np.abs(vals)
    dot = np.concatenate([vals, -vals])
    ss, dd = np.meshgrid(s, dot[::7], indexing="ij")
    return t(ss.ravel().astype(np.float32)), t(dd.ravel().astype(np.float32))


@pytest.mark.filterwarnings("ignore:overflow encountered")
def test_fold_is_the_same_bits_where_two_dot_is_finite():
    """fma(-2, dot, s) is s - 2·dot bit for bit wherever 2·dot is finite
    (2·dot is exact, and both round s - 2·dot once), s = inf included."""
    s, dot = _edge_operands()
    fold = tref.fma_f32(torch.tensor(-2.0), dot, s)
    orig = s - 2.0 * dot
    finite2 = torch.isfinite(2.0 * dot)
    assert int(finite2.sum()) > 10_000 and bool(torch.isinf(s[finite2]).any())
    assert torch.equal(bits(fold[finite2]), bits(orig[finite2]))


def test_coordinates_within_the_bound_keep_two_dot_finite():
    """|x_k|, |y_k| <= 2^62 gives |x0·y0| <= 2^124 and |dot| <= 2^125, so
    2·dot <= 2^126 is finite; the extreme points reach those values."""
    b = torch.tensor(float(FOLD_BOUND))
    for sx, sy in ((1, 1), (1, -1), (-1, 1)):
        x = torch.stack([b, b])[None] * torch.tensor([[1.0, sx]])
        y = torch.stack([b, b])[None] * torch.tensor([[1.0, sy]])
        dot = tref.fma_f32(x[:, 1], y[:, 1], x[:, 0] * y[:, 0])
        assert bool(torch.isfinite(2.0 * dot).all())
        assert float(dot.abs().max()) in (0.0, 2.0 ** 125)


@pytest.mark.parametrize("scale", [1.0, 1e-20, 1e18, float(FOLD_BOUND)])
def test_fold_equals_the_plain_test_within_the_bound(scale):
    """On points whose coordinates reach ``scale`` (at most 2^62), the fast
    path's d2 matrix is the plain version's bit for bit."""
    pts = _points("random", 512, 11)
    pts[::5] = pts[::5].round(2)  # exact ties and duplicates
    x = t((pts / np.abs(pts).max() * np.float32(scale)).astype(np.float32))
    assert float(x.abs().max()) <= float(FOLD_BOUND)
    xx = tref._sqnorm(x)
    assert torch.equal(bits(fold_d2(x, xx, x, xx)), bits(tref._d2_rows(x, xx, x, xx)))


def test_fold_differs_beyond_the_bound():
    """Beyond 2^62 the two forms part: a point whose |x|² lies in
    (FLT_MAX / 2, FLT_MAX], tested against itself, gives s - 2·dot = NaN
    and the fold inf, which an infinite eps² tells apart — so such an item
    takes the exact path."""
    x = torch.tensor([[1.35e19, 0.0]])
    xx = tref._sqnorm(x)
    assert bool(torch.isnan(tref._d2_rows(x, xx, x, xx)).all())
    assert bool(torch.isinf(fold_d2(x, xx, x, xx)).all())


# -- (4) an emulation of the kernels' schedule -----------------------------------------

def unordered_pair(q: int, m: int) -> tuple[int, int]:
    """pair_sweep.cu's unordered_pair: q in [0, m(m+1)/2) -> {a <= b}."""
    c, r = divmod(q, m)
    s = (r + c) % m
    return min(r, s), max(r, s)


def dense_items(n: int) -> tuple[list[tuple[int, int]], int]:
    """DenseItems: the unordered pairs of the ceil(n / 256) tiles."""
    size = pairwise_dist.SYM_DENSE_TILE
    tiles = -(-n // size)
    items = [unordered_pair(q, tiles) for q in range(tiles * (tiles + 1) // 2)]
    return [(a * size, b * size) for a, b in items], size


def sparse_items(p, n: int, bt: int) -> tuple[list[tuple[int, int]], int]:
    """SparseItems: the diagonal tiles' k(k+1)/2 sub-tile pairs, then k²
    for each pair of the upper list."""
    size = pairwise_dist.sym_tile(bt)
    k, tiles = bt // size, n // bt
    per = k * (k + 1) // 2
    items = []
    for q in range(tiles * per + int(p.n_up) * k * k):
        if q < tiles * per:
            tile, sub = divmod(q, per)
            a, b = unordered_pair(sub, k)
            items.append((tile * bt + a * size, tile * bt + b * size))
        else:
            pi, sub = divmod(q - tiles * per, k * k)
            items.append((int(p.up_rows[pi]) * bt + sub // k * size,
                          int(p.up_cols[pi]) * bt + sub % k * size))
    return items, size


def weights(mask, labels, core):
    """w = (mask && core) ? label : 2^30, as the kernels stage it."""
    return torch.where(mask & core, labels.to(torch.int32), SENT)


def fast_item(x, w, ia, ib) -> bool:
    """pair_sweep.cu's per-item choice: every coordinate of both tiles within
    2^62 (not NaN), and a point of w <= 2^30 in each tile."""
    pts = torch.cat([x[ia], x[ib]])
    return bool((pts.abs() <= float(FOLD_BOUND)).all()) and bool((w[ia] <= SENT).any()) \
        and bool((w[ib] <= SENT).any())


def emulate(x, mask, labels, core, eps, items, size, start, seed, path_counts=None):
    """The kernels' result: the output starts at ``start`` (INT_MAX dense,
    2^30 sparse); for each item {A, B} in a shuffled order, every pair of
    A × B tested once, on the fast path (the fold; row and column mins from
    2^30, predicated) or the exact path (s - 2·dot; (within ? w : 2^30)
    from INT_MAX); a row whose mask is false writes 2^30; a write of the
    start value or more is skipped."""
    n = x.shape[0]
    x = x.to(torch.float32)
    xx = tref._sqnorm(x)
    w = weights(mask, labels, core)
    e = torch.tensor(tref.eps_sq_f32(eps), dtype=torch.float32)
    out = torch.full((n,), start, dtype=torch.int32)
    rng = np.random.default_rng(seed)

    def values(ia, ib, fast):
        if fast:
            ok = fold_d2(x[ia], xx[ia], x[ib], xx[ib]) <= e
            rmin = torch.where(ok, w[ib][None, :], SENT).amin(dim=1)
            cmin = torch.where(ok, w[ia][:, None], SENT).amin(dim=0)
            return rmin, cmin
        # exact: each direction on its own, as the plain version tests it
        ok_r = tref._d2_rows(x[ia], xx[ia], x[ib], xx[ib]) <= e
        ok_c = tref._d2_rows(x[ib], xx[ib], x[ia], xx[ia]) <= e
        rmin = torch.where(ok_r, w[ib][None, :], SENT).amin(dim=1)
        cmin = torch.where(ok_c, w[ia][None, :], SENT).amin(dim=1)
        return rmin, cmin

    def commit(idx, v):
        v = torch.where(mask[idx], v, SENT)
        write = v < start
        out[idx[write]] = torch.minimum(out[idx[write]], v[write])

    for q in rng.permutation(len(items)):
        a0, b0 = items[q]
        ia, ib = torch.arange(a0, min(a0 + size, n)), torch.arange(b0, min(b0 + size, n))
        fast = fast_item(x, w, ia, ib)
        if path_counts is not None:
            path_counts["fast" if fast else "exact"] += 1
        rmin, cmin = values(ia, ib, fast)
        if a0 == b0:
            commit(ia, torch.minimum(rmin, cmin))
        else:
            commit(ia, rmin)
            commit(ib, cmin)
    return out


def _covered(items, size):
    """Every unordered pair of size-tiles the items cover, with multiplicity."""
    seen = {}
    for a0, b0 in items:
        key = (min(a0, b0) // size, max(a0, b0) // size)
        seen[key] = seen.get(key, 0) + 1
    return seen


@pytest.mark.parametrize("n", [1, 255, 256, 600, 1000, 1537])
def test_dense_items_cover_each_tile_pair_once(n):
    items, size = dense_items(n)
    tiles = -(-n // size)
    seen = _covered(items, size)
    assert len(items) == pairwise_dist.sym_work_items(n) == tiles * (tiles + 1) // 2
    assert set(seen) == {(a, b) for a in range(tiles) for b in range(a, tiles)}
    assert set(seen.values()) == {1}


@pytest.mark.parametrize("layout,n,bt,eps,empty_tile", PAIR_CASES)
def test_sparse_items_cover_each_active_subtile_pair_once(layout, n, bt, eps, empty_tile):
    sp, sm = _sorted(layout, n, bt, n + bt, empty_tile)
    p = ops.build_tile_pairs(sp, sm, eps, bt=bt)
    npad = sp.shape[0]
    items, size = sparse_items(p, npad, bt)
    assert len(items) == pairwise_dist.sym_work_items(npad, p, bt=bt)
    a = _active(p, npad // bt)
    k = bt // size
    want = {(i, j) for i in range(npad // size) for j in range(i, npad // size)
            if a[i // k, j // k]}
    seen = _covered(items, size)
    assert set(seen) == want and set(seen.values()) == {1}


def _sweep_inputs(n, seed, kind="normal"):
    """Points, mask, labels and core flags.  ``kind``: "normal"; "all_masked"
    (no row takes part); "no_core"; "big" (labels up to INT32_MAX, most
    above 2^30); "big_tile" (the first tile of 256 masked core points with
    labels above 2^30, the rest normal); "all_big" (every point masked,
    core and labelled above 2^30: with eps wide enough every row's plain
    result is a label above 2^30)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2)).astype(np.float32)
    mask = rng.random(n) > (1.1 if kind == "all_masked" else 0.2)
    labels = rng.permutation(n).astype(np.int32)
    labels[::5] = SENT
    core = rng.random(n) > (1.1 if kind == "no_core" else 0.5)
    if kind == "big":
        labels = rng.integers(0, 2**31 - 1, n, endpoint=True).astype(np.int32)
    elif kind == "big_tile":
        labels[:256] = rng.integers(SENT + 1, 2**31 - 1, 256, endpoint=True)
        mask[:256] = core[:256] = True
    elif kind == "all_big":
        labels = rng.integers(SENT + 1, 2**31 - 1, n, endpoint=True).astype(np.int32)
        mask[:] = core[:] = True
    return x, mask, labels, core


def _jargs(*arrays):
    return tuple(jnp.asarray(np.asarray(a)) for a in arrays)


# tests/test_torch_kernels.py's cases, then ragged n, n = 1, all rows masked,
# no core point, several tiles, and labels above 2^30: some, a whole tile of
# them (its items take the exact path), and all (every item does).
DENSE_CASES = [(128, 0.4, "normal"), (300, 0.25, "normal"), (1, 0.1, "normal"),
               (1000, 0.1, "normal"), (700, 0.3, "all_masked"), (513, 0.3, "no_core"),
               (1537, 0.08, "normal"), (600, 0.3, "big"), (1000, 0.5, "big_tile"),
               (300, 100.0, "all_big"), (600, 1.0, "all_big")]


@pytest.mark.parametrize("n,eps,kind", DENSE_CASES)
def test_dense_schedule_equals_the_references(n, eps, kind):
    x, mask, labels, core = _sweep_inputs(n, n + 17, kind)
    items, size = dense_items(n)
    paths = {"fast": 0, "exact": 0}
    got = emulate(t(x), t(mask), t(labels), t(core), eps, items, size, NONE, seed=n,
                  path_counts=paths)
    want = tref.min_label_sweep(t(x), t(mask), t(labels), t(core), eps)
    assert torch.equal(got, want)
    jargs = _jargs(x, mask, labels, core)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.min_label_sweep(*jargs, eps)))
    if kind in ("big_tile", "all_big"):
        assert paths["exact"] > 0
    else:
        assert paths == {"fast": len(items), "exact": 0}
    if kind == "all_big" and eps > 50:
        assert bool((got > SENT).all())  # every row's min is a label above 2^30
    elif n <= 512:
        # The Pallas kernel starts its accumulator at 2^30, so it agrees with
        # the reference wherever some column of a row is not within eps.
        pallas = jpd.min_label_sweep(*jargs, eps, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.filterwarnings("ignore:overflow encountered")  # eps² of 1e20 is inf
def test_dense_schedule_beyond_the_fold_bound():
    """eps² = inf with a point whose |x|² lies in (FLT_MAX / 2, FLT_MAX]:
    the items holding it take the exact path and equal the references;
    had they taken the fold, row 3 would have found its own label."""
    x, mask, labels, core = _sweep_inputs(600, 5)
    x = (x * np.float32(1e17)).astype(np.float32)  # within 2^62 but for point 3
    x[3] = (1.35e19, 0.0)
    mask[3] = core[3] = True
    labels[3] = -1  # the least label: only point 3's own test can give it to row 3
    items, size = dense_items(600)
    args = (t(x), t(mask), t(labels), t(core), 1e20)
    want = tref.min_label_sweep(*args)
    paths = {"fast": 0, "exact": 0}
    assert torch.equal(emulate(*args, items, size, NONE, seed=1, path_counts=paths), want)
    assert paths["exact"] == 3  # the first tile's three items
    np.testing.assert_array_equal(want.numpy(),
                                  np.asarray(jref.min_label_sweep(*_jargs(x, mask, labels, core),
                                                                  1e20)))
    xx = tref._sqnorm(args[0])
    ok = fold_d2(args[0], xx, args[0], xx) <= torch.tensor(np.float32(np.inf))
    folded = torch.where(ok & args[1][:, None], weights(*args[1:4])[None, :], SENT).amin(dim=1)
    assert not torch.equal(torch.where(args[1], folded, SENT), want)


# tests/test_torch_blocksparse.py's SPARSE_CASES (bt 64, against the JAX
# reference and the interpret-mode Pallas kernel), then bt 96 (sub-tiles of
# 32), 128 and 512, and labels above 2^30.
SPARSE_SWEEP_CASES = [("random", 384, 64, 0.03, False, "normal"),
                      ("random", 384, 64, 0.1, True, "normal"),
                      ("clustered", 384, 64, 0.03, True, "normal"),
                      ("clustered", 384, 64, 0.1, False, "normal"),
                      ("one_cell", 384, 64, 0.03, False, "normal"),
                      ("one_cell", 384, 64, 0.03, False, "big"),
                      ("clustered", 384, 64, 0.1, False, "all_big"),
                      ("clustered", 2048, 96, 0.05, False, "normal"),
                      ("clustered", 4096, 128, 0.03, True, "normal"),
                      ("random", 4096, 512, 0.02, False, "normal"),
                      ("one_cell", 2048, 128, 0.01, False, "big")]


@pytest.mark.parametrize("layout,n,bt,eps,empty_tile,kind", SPARSE_SWEEP_CASES)
def test_sparse_schedule_equals_the_references(layout, n, bt, eps, empty_tile, kind):
    sp, sm = _sorted(layout, n, bt, n + bt + 1, empty_tile)
    npad = sp.shape[0]
    rng = np.random.default_rng(13)
    labels = t(rng.permutation(npad).astype(np.int32))
    labels[::9] = SENT
    core = t(rng.random(npad) > 0.4)
    if kind == "big":
        labels = t(rng.integers(0, 2**31 - 1, npad, endpoint=True).astype(np.int32))
    elif kind == "all_big":
        labels = t(rng.integers(SENT + 1, 2**31 - 1, npad, endpoint=True).astype(np.int32))
        core[:] = True
    p = ops.build_tile_pairs(sp, sm, eps, bt=bt)
    items, size = sparse_items(p, npad, bt)
    got = emulate(sp, sm, labels, core, eps, items, size, SENT, seed=npad)
    want = tref.min_label_sweep_sparse(sp, sm, labels, core, eps, p.rows, p.cols, p.flags, bt)
    assert torch.equal(got, want)
    # Over a list that holds every active pair, the sparse sweep is the
    # dense one capped at 2^30 (its accumulator starts there).
    dense = tref.min_label_sweep(sp, sm, labels, core, eps)
    assert torch.equal(got, dense.clamp_max(SENT))
    if bt == 64:
        jargs = _jargs(sp.numpy(), sm.numpy(), labels.numpy(), core.numpy())
        jp = _jargs(p.rows.numpy(), p.cols.numpy(), p.flags.numpy())
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jref.min_label_sweep_sparse(*jargs, eps, *jp, bt)))
        pallas = jpd.min_label_sweep_sparse(*jargs, eps, *jp, bt=bt, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_sub_tiles_divide_every_bt():
    for bt in range(32, 1025, 32):
        s = pairwise_dist.sym_tile(bt)
        assert bt % s == 0 and s in (256, 128, 64, 32)
        assert s == 256 or bt % (2 * s) or 2 * s > 256
    assert pairwise_dist.sym_tile(512) == 256 and pairwise_dist.sym_tile(64) == 64


# -- dbscan's sweeps take the fast path in every item --------------------------------

@pytest.mark.parametrize("block_sparse", ["never", "always"])
@pytest.mark.parametrize("pointer_doubling", [True, False])
def test_dbscan_sweeps_take_the_fast_path(monkeypatch, block_sparse, pointer_doubling):
    """dbscan's labels are indices below 2^30 and its points centred, so
    every item of every sweep it makes takes the fast path (the exact path
    is there for other callers)."""
    calls = []

    def spy(name):
        fn = getattr(ops, name)

        def wrapped(x, mask, labels, core, eps, *args, **kw):
            calls.append((name, x, weights(mask, labels, core), kw.get("bt")))
            return fn(x, mask, labels, core, eps, *args, **kw)
        monkeypatch.setattr(ops, name, wrapped)

    spy("min_label_sweep")
    spy("min_label_sweep_sparse")
    pts = torch.from_numpy(spatial.make_clustered(2048, seed=3))
    mask = torch.ones(2048, dtype=torch.bool)
    mask[::7] = False
    tdb.dbscan(pts, mask, 0.03, 4, block_sparse=block_sparse, bt=128,
               pointer_doubling=pointer_doubling)
    want = "min_label_sweep_sparse" if block_sparse == "always" else "min_label_sweep"
    assert calls and {c[0] for c in calls} == {want}
    for name, x, w, bt in calls:
        size = pairwise_dist.sym_tile(bt) if bt else pairwise_dist.SYM_DENSE_TILE
        tiles = [torch.arange(a, min(a + size, x.shape[0])) for a in range(0, x.shape[0], size)]
        assert all(fast_item(x, w, ia, ia) for ia in tiles)
