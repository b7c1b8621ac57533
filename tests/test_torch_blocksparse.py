"""The port's block-sparse phase 1 against the reference package's, on the
same seeded inputs: the Morton code, ``spatial_sort``, ``build_tile_pairs``
(against the jitted reference, which is how ``dbscan`` runs it), the two
sparse plain versions (against ``repro.kernels.ref``, the interpret-mode
Pallas kernels and the dense plain versions), ``dbscan(block_sparse=
"always")`` on the tests/test_blocksparse.py cases, and the committed
``BENCH_phase1.json`` pair counts.  Everything is exact."""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import dbscan as jdb  # noqa: E402
from repro.core import partitioner as jpart  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import pairwise_dist as jpd  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import dbscan as tdb  # noqa: E402
from repro_torch.core import ddc as tddc  # noqa: E402
from repro_torch.core import partitioner as tpart  # noqa: E402
from repro_torch.data import spatial  # noqa: E402
from repro_torch.kernels import ops, pairwise_dist  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

j_morton = jax.jit(lambda p, lo, hi: jpart.morton_code(p, bounds=(lo[0], lo[1], hi[0], hi[1])))
j_morton_own = jax.jit(jpart.morton_code)
j_sort = jax.jit(jdb.spatial_sort, static_argnums=2)
j_pairs = jax.jit(jops.build_tile_pairs, static_argnames="bt")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.array(a))


def make_layout(name: str, n: int, seed: int) -> np.ndarray:
    """tests/test_blocksparse.py's layouts, from a seed of their own."""
    rng = np.random.default_rng(seed)
    if name == "random":
        return rng.uniform(0, 1, (n, 2)).astype(np.float32)
    if name == "clustered":
        return spatial.make_clustered(n, seed=int(rng.integers(1 << 20)))
    if name == "one_cell":  # adversarial: zero pruning possible
        return (0.5 + rng.normal(0, 0.001, (n, 2))).astype(np.float32)
    raise ValueError(name)


def sorted_both(pts, mask, bt):
    """The reference's and the port's spatial_sort of the same inputs."""
    jsp, jsm, jorder = j_sort(jnp.asarray(pts), jnp.asarray(mask), bt)
    tsp, tsm, torder = tdb.spatial_sort(t(pts), t(mask), bt)
    return (jsp, jsm, jorder), (tsp, tsm, torder)


def assert_pairs_equal(jp, tp):
    for field in jops.TilePairs._fields:
        np.testing.assert_array_equal(getattr(tp, field).numpy(),
                                      np.asarray(getattr(jp, field)), err_msg=field)
    assert tp.rows.dtype == tp.cols.dtype == tp.flags.dtype == torch.int32
    assert tp.frac.dtype == torch.float32


# -- the Morton code ----------------------------------------------------------

MORTON_CASES = {
    "random": lambda r: r.uniform(0, 1, (500, 2)),
    "offset": lambda r: r.uniform(0, 1, (500, 2)) * 3.7 + 1000.0,
    "negative": lambda r: r.normal(0, 5.0, (300, 2)),
    "one_point": lambda r: r.uniform(0, 1, (1, 2)),
    "all_equal": lambda r: np.full((64, 2), 0.25),
    "one_axis_flat": lambda r: np.stack([r.uniform(0, 1, 100), np.full(100, 0.5)], -1),
}


@pytest.mark.parametrize("name", list(MORTON_CASES))
def test_morton_code_own_bounds(name):
    pts = MORTON_CASES[name](np.random.default_rng(1)).astype(np.float32)
    want = np.asarray(j_morton_own(jnp.asarray(pts)))
    got = tpart.morton_code(t(pts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bounds", [(0.0, 0.0, 1.0, 1.0), (0.2, 0.1, 0.7, 0.9),
                                    (0.5, 0.5, 0.5, 0.5), (3.0, 3.0, 4.0, 4.0)])
def test_morton_code_given_bounds(bounds):
    """Bounds as traced values, as spatial_sort passes them; points outside
    them take the edge cells."""
    pts = np.random.default_rng(2).uniform(-0.5, 1.5, (400, 2)).astype(np.float32)
    lo, hi = np.float32(bounds[:2]), np.float32(bounds[2:])
    want = np.asarray(j_morton(jnp.asarray(pts), jnp.asarray(lo), jnp.asarray(hi)))
    np.testing.assert_array_equal(tpart.morton_code(t(pts), bounds=bounds).numpy(), want)
    as_tensors = (t(lo)[0], t(lo)[1], t(hi)[0], t(hi)[1])
    np.testing.assert_array_equal(tpart.morton_code(t(pts), bounds=as_tensors).numpy(), want)


def test_morton_code_non_finite_points():
    """NaN, infinities and far-out points take the cells the reference's
    saturating float-to-int cast gives them."""
    pts = np.array([[0.1, 0.2], [np.nan, 0.5], [np.inf, -np.inf], [1e30, -1e30],
                    [0.9, np.nan]], np.float32)
    lo, hi = np.float32([0, 0]), np.float32([1, 1])
    want = np.asarray(j_morton(jnp.asarray(pts), jnp.asarray(lo), jnp.asarray(hi)))
    got = tpart.morton_code(t(pts), bounds=(0.0, 0.0, 1.0, 1.0))
    np.testing.assert_array_equal(got.numpy(), want)


def test_morton_code_matches_numpy_copy():
    pts = np.random.default_rng(3).uniform(0, 1, (256, 2)).astype(np.float32)
    np.testing.assert_array_equal(tpart.morton_code(t(pts)).numpy(), spatial.morton_code(pts))


# -- spatial_sort ---------------------------------------------------------------

@pytest.mark.parametrize("layout,n,bt", [("random", 500, 64), ("clustered", 500, 64),
                                         ("one_cell", 500, 64), ("clustered", 777, 128),
                                         ("random", 256, 128)])
def test_spatial_sort(layout, n, bt):
    pts = make_layout(layout, n, seed=n + bt)
    mask = np.random.default_rng(n).random(n) > 0.2
    (jsp, jsm, jorder), (tsp, tsm, torder) = sorted_both(pts, mask, bt)
    assert tsp.shape[0] % bt == 0 and torder.dtype == torch.int64
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(tsp.numpy(), np.asarray(jsp))
    np.testing.assert_array_equal(tsm.numpy(), np.asarray(jsm))


def test_spatial_sort_ties_keep_caller_order():
    """Equal Morton codes are routine: the sort must be stable."""
    pts = np.repeat(np.random.default_rng(4).uniform(0, 1, (8, 2)), 40, axis=0)
    pts = pts.astype(np.float32)
    mask = np.ones(len(pts), bool)
    (_, _, jorder), (_, _, torder) = sorted_both(pts, mask, 64)
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))


# -- build_tile_pairs -------------------------------------------------------------

@pytest.mark.parametrize("layout", ["random", "clustered", "one_cell"])
@pytest.mark.parametrize("eps", [0.03, 0.1])
def test_build_tile_pairs(layout, eps):
    pts = make_layout(layout, 500, seed=7)
    mask = np.random.default_rng(8).random(500) > 0.2
    (jsp, jsm, _), (tsp, tsm, _) = sorted_both(pts, mask, 64)
    tp = ops.build_tile_pairs(tsp, tsm, eps, bt=64)
    assert_pairs_equal(j_pairs(jsp, jsm, eps, bt=64), tp)
    # The CSR offsets the kernels launch from.
    n_active = int(tp.n_active)
    rows = tp.rows[:n_active]
    want_ptr = torch.searchsorted(rows, torch.arange(tp.row_ptr.shape[0], dtype=torch.int32))
    np.testing.assert_array_equal(tp.row_ptr.numpy(), want_ptr.numpy())


@pytest.mark.parametrize("n", [192, 320, 384, 448])
def test_build_tile_pairs_fraction_form(n):
    """T² that is not a power of two: frac is n_active times the float32
    reciprocal of T², as the jitted reference computes it, which decides
    the dense fallback at its threshold."""
    pts = make_layout("clustered", n, seed=n)
    mask = np.ones(n, bool)
    (jsp, jsm, _), (tsp, tsm, _) = sorted_both(pts, mask, 64)
    for eps in (0.02, 0.05, 0.2):
        assert_pairs_equal(j_pairs(jsp, jsm, eps, bt=64),
                           ops.build_tile_pairs(tsp, tsm, eps, bt=64))


def test_build_tile_pairs_empty_tiles():
    """Masked tail tiles (padding) take part in no pair but their diagonal."""
    pts = spatial.make_clustered(200, seed=5)
    padded = np.concatenate([pts, np.zeros((184, 2), np.float32)])
    mask = np.arange(384) < 200
    (jsp, jsm, _), (tsp, tsm, _) = sorted_both(padded, mask, 64)
    tp = ops.build_tile_pairs(tsp, tsm, 0.05, bt=64)
    assert_pairs_equal(j_pairs(jsp, jsm, 0.05, bt=64), tp)
    assert int(tp.row_ptr[-1] - tp.row_ptr[-2]) == 1


def test_bbox_gap_is_the_jitted_fma_form():
    """XLA contracts the reference's gap·gap sum into fma(g1, g1, g0·g0)
    under jit; the port computes that single rounding exactly."""
    rng = np.random.default_rng(9)
    lo = rng.uniform(0, 1, (64, 2)).astype(np.float32)
    hi = (lo + rng.uniform(0, 0.2, (64, 2))).astype(np.float32)

    def gap_d2(lo, hi):
        gap = jnp.maximum(lo[:, None, :] - hi[None, :, :], lo[None, :, :] - hi[:, None, :])
        gap = jnp.maximum(gap, 0.0)
        return gap, jnp.sum(gap * gap, axis=-1)

    gap, want = (np.asarray(a) for a in jax.jit(gap_d2)(lo, hi))
    unfused = gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]
    assert (unfused != want).any()  # the contraction is real on this input
    g = t(gap)
    got = tref.fma_f32(g[..., 1], g[..., 1], g[..., 0] * g[..., 0])
    np.testing.assert_array_equal(got.numpy(), want)


def _boundary_case():
    """Two tiles whose box gap sits exactly at eps² in one rounding of
    the gap sum and past it in the other, and that eps."""
    rng = np.random.default_rng(10)
    for _ in range(2000):
        hi0 = rng.uniform(0.1, 0.5, 2).astype(np.float32)
        lo1 = (hi0 + rng.uniform(0.01, 0.3, 2)).astype(np.float32)
        g = lo1 - hi0
        unfused = np.float32(g[0] * g[0] + g[1] * g[1])
        fused = np.float32(np.float64(g[1]) * np.float64(g[1]) + np.float64(g[0] * g[0]))
        if unfused == fused:
            continue
        target = min(unfused, fused)
        root = np.float32(np.sqrt(target))
        for e in (root, np.nextafter(root, np.float32(0)), np.nextafter(root, np.float32(1))):
            if np.float32(e * e) == target:
                tile0 = np.concatenate([np.zeros((1, 2)), hi0[None], np.full((30, 2), hi0 / 2)])
                tile1 = np.concatenate([lo1[None], lo1[None] + 0.1, np.full((30, 2), lo1 + 0.05)])
                x = np.concatenate([tile0, tile1]).astype(np.float32)
                return x, float(e), fused <= target
    raise AssertionError("no boundary case found")


def test_build_tile_pairs_at_the_eps_boundary():
    x, eps, fused_active = _boundary_case()
    mask = np.ones(len(x), bool)
    jp = j_pairs(jnp.asarray(x), jnp.asarray(mask), eps, bt=32)
    tp = ops.build_tile_pairs(t(x), t(mask), eps, bt=32)
    assert_pairs_equal(jp, tp)
    assert int(tp.n_active) == (4 if fused_active else 2)


def _bench_points(scenario: str, n: int) -> np.ndarray:
    if scenario == "uniform":
        return np.random.default_rng(0).uniform(0, 1, (n, 2)).astype(np.float32)
    if scenario == "clustered":
        return spatial.make_clustered(n, seed=0)
    return spatial.make_worm(n, seed=0)


BENCH = json.loads((ROOT / "BENCH_phase1.json").read_text())


@pytest.mark.parametrize("row", BENCH["rows"], ids=lambda r: f"{r['scenario']}-{r['n']}")
def test_bench_phase1_pair_counts(row):
    """The committed active-pair counts are hardware-independent: the
    port's sort and pruning reproduce them from the port's generators."""
    pts = _bench_points(row["scenario"], row["n"])
    mask = torch.ones(len(pts), dtype=torch.bool)
    sp, sm, _ = tdb.spatial_sort(t(pts), mask, row["bt"])
    tp = ops.build_tile_pairs(sp, sm, row["eps"], bt=row["bt"])
    assert sp.shape[0] // row["bt"] == row["tiles"]
    assert int(tp.n_active) == row["n_active_pairs"]
    assert round(float(tp.frac), 4) == row["active_frac"]


@pytest.mark.parametrize("row", [r for r in BENCH["rows"]
                                 if r["n"] == 4096 and r["scenario"] != "worm"],
                         ids=lambda r: r["scenario"])
def test_bench_phase1_cluster_counts(row):
    """The committed cluster counts, through the block-sparse path on the
    sparse plain versions.  (The worm row takes 16 s of one CPU core in
    this form; chip_smoke.py holds all six clustering rows on the card.)"""
    pts = _bench_points(row["scenario"], row["n"])
    res, path = tdb.dbscan_traced(t(pts), torch.ones(len(pts), dtype=torch.bool), row["eps"],
                                  BENCH["min_pts"], block_sparse="always", bt=row["bt"],
                                  dense_fallback_frac=1.0)
    assert path == {"path": "sparse", "n_active": row["n_active_pairs"],
                    "frac": pytest.approx(row["active_frac"], abs=5e-5)}
    assert int(res.n_clusters) == row["n_clusters"]


# -- the sparse plain versions -------------------------------------------------------

def _sparse_inputs(layout, eps, seed, n=384, bt=64, empty_tile=False):
    pts = make_layout(layout, n, seed)
    mask = np.random.default_rng(seed + 1).random(n) > 0.15
    if empty_tile:
        mask[-bt:] = False  # after the sort, the last tile holds only masked rows
    (jsp, jsm, _), (tsp, tsm, _) = sorted_both(pts, mask, bt)
    return (jsp, jsm, j_pairs(jsp, jsm, eps, bt=bt)), (tsp, tsm, ops.build_tile_pairs(
        tsp, tsm, eps, bt=bt))


SPARSE_CASES = [("random", 0.03, False), ("random", 0.1, True), ("clustered", 0.03, True),
                ("clustered", 0.1, False), ("one_cell", 0.03, False)]


@pytest.mark.parametrize("layout,eps,empty_tile", SPARSE_CASES)
def test_neighbor_count_sparse(layout, eps, empty_tile):
    (jsp, jsm, jp), (tsp, tsm, tp) = _sparse_inputs(layout, eps, 11, empty_tile=empty_tile)
    got = tref.neighbor_count_sparse(tsp, tsm, eps, tp.rows, tp.cols, tp.flags, 64)
    assert got.dtype == torch.int32
    want = np.asarray(jref.neighbor_count_sparse(jsp, jsm, eps, jp.rows, jp.cols, jp.flags, 64))
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = jpd.neighbor_count_sparse(jsp, jsm, eps, jp.rows, jp.cols, jp.flags, bt=64,
                                       interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    assert torch.equal(got, tref.neighbor_count(tsp, tsm, eps))
    # The wrapper and the dispatch take the plain version for CPU tensors.
    assert torch.equal(ops.neighbor_count_sparse(tsp, tsm, eps, tp, bt=64), got)


@pytest.mark.parametrize("layout,eps,empty_tile", SPARSE_CASES)
def test_min_label_sweep_sparse(layout, eps, empty_tile):
    (jsp, jsm, jp), (tsp, tsm, tp) = _sparse_inputs(layout, eps, 12, empty_tile=empty_tile)
    rng = np.random.default_rng(13)
    n = tsp.shape[0]
    labels = rng.permutation(n).astype(np.int32)
    labels[::9] = tref.SENTINEL
    core = rng.random(n) > 0.4
    got = tref.min_label_sweep_sparse(tsp, tsm, t(labels), t(core), eps, tp.rows, tp.cols,
                                      tp.flags, 64)
    assert got.dtype == torch.int32
    jl, jc = jnp.asarray(labels), jnp.asarray(core)
    want = jref.min_label_sweep_sparse(jsp, jsm, jl, jc, eps, jp.rows, jp.cols, jp.flags, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pallas = jpd.min_label_sweep_sparse(jsp, jsm, jl, jc, eps, jp.rows, jp.cols, jp.flags,
                                        bt=64, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    assert torch.equal(got, tref.min_label_sweep(tsp, tsm, t(labels), t(core), eps))
    assert torch.equal(ops.min_label_sweep_sparse(tsp, tsm, t(labels), t(core), eps, tp,
                                                  bt=64), got)


def test_pair_chunks_change_no_bit(monkeypatch):
    _, (tsp, tsm, tp) = _sparse_inputs("clustered", 0.1, 14)
    whole = tref.neighbor_count_sparse(tsp, tsm, 0.1, tp.rows, tp.cols, tp.flags, 64)
    lab = torch.arange(tsp.shape[0], dtype=torch.int32)
    core = torch.ones(tsp.shape[0], dtype=torch.bool)
    sweep = tref.min_label_sweep_sparse(tsp, tsm, lab, core, 0.1, tp.rows, tp.cols, tp.flags, 64)
    monkeypatch.setattr(tref, "PAIR_CHUNK", 3 * 64 * 64)
    assert torch.equal(tref.neighbor_count_sparse(tsp, tsm, 0.1, tp.rows, tp.cols, tp.flags,
                                                  64), whole)
    assert torch.equal(tref.min_label_sweep_sparse(tsp, tsm, lab, core, 0.1, tp.rows, tp.cols,
                                                   tp.flags, 64), sweep)


def test_sparse_shapes_are_checked():
    x = torch.zeros((100, 2))
    mask = torch.ones(100, dtype=torch.bool)
    flags = torch.ones(1, dtype=torch.int32)
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        tref.neighbor_count_sparse(x, mask, 0.1, z, z, flags, 64)
    with pytest.raises(ValueError, match="multiple"):
        ops.build_tile_pairs(x, mask, 0.1, bt=64)
    with pytest.raises(ValueError):
        pairwise_dist.neighbor_count_sparse(torch.zeros((128, 2), device="meta"),
                                            torch.ones(128, dtype=torch.bool, device="meta"),
                                            0.1, None, bt=64)


def test_cpu_tensors_never_launch_the_sparse_kernels():
    ops.reset_launch_counts()
    _, (tsp, tsm, tp) = _sparse_inputs("random", 0.1, 15)
    ops.neighbor_count_sparse(tsp, tsm, 0.1, tp, bt=64)
    lab = torch.arange(tsp.shape[0], dtype=torch.int32)
    ops.min_label_sweep_sparse(tsp, tsm, lab, tsm, 0.1, tp, bt=64)
    counts = ops.launch_counts()
    assert counts["neighbor_count_sparse"] == counts["min_label_sweep_sparse"] == 0
    assert set(counts) == {"neighbor_count", "min_label_sweep", "neighbor_count_sparse",
                           "min_label_sweep_sparse", "pairwise_dist_sq", "contour_min_d2",
                           "cross_min_d2", "flash_attention", "ssd_scan", "dispatch_gather"}


# -- dbscan(block_sparse="always") -------------------------------------------------

def _blobs_masked():
    pts, _ = spatial.make_blobs(700, 6, seed=11)
    return pts, np.random.default_rng(16).random(700) > 0.1, 0.05, 5, {"bt": 64}


def _padded():
    pts, _ = spatial.make_blobs(220, 3, seed=4)
    padded = np.concatenate([pts, np.zeros((120, 2), np.float32)])
    return padded, np.arange(340) < 220, 0.05, 5, {"bt": 64}


def _offset():
    pts = spatial.make_clustered(500, seed=3) + np.float32(100.0)
    return pts, np.ones(500, bool), 0.05, 5, {"bt": 64}


DBSCAN_CASES = {
    "oracle_random": lambda: (make_layout("random", 420, 17), np.ones(420, bool), 0.05, 5,
                              {"bt": 64}),
    "oracle_clustered": lambda: (make_layout("clustered", 420, 18), np.ones(420, bool), 0.05,
                                 5, {"bt": 64}),
    "oracle_one_cell": lambda: (make_layout("one_cell", 420, 19), np.ones(420, bool), 0.002,
                                5, {"bt": 64}),
    "oracle_random_sparse": lambda: (make_layout("random", 420, 17), np.ones(420, bool), 0.05,
                                     5, {"bt": 64, "dense_fallback_frac": 1.0}),
    "oracle_one_cell_sparse": lambda: (make_layout("one_cell", 420, 19), np.ones(420, bool),
                                       0.002, 5, {"bt": 64, "dense_fallback_frac": 1.0}),
    "sparse_equals_dense": _blobs_masked,
    "dense_fallback": lambda: (make_layout("one_cell", 300, 20), np.ones(300, bool), 0.002,
                               4, {"bt": 64, "dense_fallback_frac": 0.1}),
    "padding_mask": _padded,
    "offset": _offset,
    "worm_oracle": lambda: (spatial.make_worm(800, seed=3), np.ones(800, bool), 0.02, 5,
                            {"bt": 128}),
    "no_doubling": lambda: (spatial.make_worm(512, seed=2), np.ones(512, bool), 0.02, 5,
                            {"bt": 64, "pointer_doubling": False}),
}


@pytest.mark.parametrize("name", list(DBSCAN_CASES))
def test_block_sparse_dbscan_equals_reference(name):
    pts, mask, eps, min_pts, kw = DBSCAN_CASES[name]()
    j = jdb.dbscan(jnp.asarray(pts), jnp.asarray(mask), eps, min_pts,
                   block_sparse="always", **kw)
    got, path = tdb.dbscan_traced(t(pts), t(mask), eps, min_pts, block_sparse="always", **kw)
    for field in tdb.DBSCANResult._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(j, field)), err_msg=field)
    assert got.labels.dtype == torch.int32 and got.n_sweeps.dtype == torch.int32
    # Bit-identical to the dense path in everything but the sweep count.
    dense = tdb.dbscan(t(pts), t(mask), eps, min_pts, block_sparse="never")
    for a, b in zip(got[:3], dense[:3]):
        assert torch.equal(a, b)
    if mask.all():
        np.testing.assert_array_equal(got.labels.numpy(), tdb.dbscan_ref(pts, eps, min_pts))
    # The path the reference takes: the same pair list of the centred
    # points (centring multiplies by 0.5 only, so it is exact in both),
    # the same fallback.
    xc = tdb.center_points(t(pts), t(mask)).numpy()
    jsp, jsm, _ = j_sort(jnp.asarray(xc), jnp.asarray(mask), kw["bt"])
    jp = j_pairs(jsp, jsm, eps, bt=kw["bt"])
    limit = np.float32(kw.get("dense_fallback_frac", tdb.DENSE_FALLBACK_FRAC))
    assert path == {"path": "sparse" if np.asarray(jp.frac) <= limit else "dense_fallback",
                    "n_active": int(jp.n_active), "frac": float(jp.frac)}
    if name in ("dense_fallback", "oracle_random"):
        assert path["path"] == "dense_fallback"
    if name.endswith("_sparse"):
        assert path["path"] == "sparse"


# -- the phase-1 and pipeline entry points ---------------------------------------------

def test_local_phase_sparse_equals_dense():
    pts = spatial.make_clustered(1024, 6, seed=21)
    mask = t(np.arange(1024) < 1000)
    outs = [tddc.local_phase(t(pts), mask, tddc.DDCConfig(
        eps=0.02, min_pts=4, schedule="sync", block_sparse=bs, block_tile=128))
        for bs in ("always", "never")]
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["d2", "worm_default"])
def test_make_ddc_fn_sparse_equals_dense(name):
    make, eps, min_pts, grid, max_verts, max_clusters = spatial.PARITY_CASES[name]
    pts = make()
    mask = np.ones(len(pts), bool)
    runs = []
    for bs in ("always", "never"):
        cfg = tddc.DDCConfig(eps=eps, min_pts=min_pts, grid=grid, max_verts=max_verts,
                             max_clusters=max_clusters, schedule="sync", block_sparse=bs,
                             block_tile=64)
        trace: dict = {}
        runs.append((tddc.make_ddc_fn(cfg, 2, device="cpu")(pts, mask, trace), trace))
    (sparse, ts), (dense, td) = runs
    for a, b in zip((sparse[0], *sparse[1], sparse[2]), (dense[0], *dense[1], dense[2])):
        assert torch.equal(a, b)
    for rs, rd in zip(ts["results"], td["results"]):
        for a, b in zip(rs[:3], rd[:3]):
            assert torch.equal(a, b)
    # Lane by lane the fallback rule picks the path; at least one lane
    # runs the sparse kernels' plain versions.
    paths = ts["paths"]
    assert [p["path"] for p in paths] == [
        "sparse" if p["frac"] <= tdb.DENSE_FALLBACK_FRAC else "dense_fallback" for p in paths]
    assert "sparse" in [p["path"] for p in paths]
    assert td["paths"] == [{"path": "dense", "n_active": None, "frac": None}] * 2
