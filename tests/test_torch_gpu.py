"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc (the kernels build at first
use); elsewhere they skip.  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

This file imports no JAX, so it runs where only PyTorch is installed.
DDC's kernels and plain versions compute the same float32 expressions,
each FMA where the other has one and no other contraction, so every
comparison of theirs is exact.  The LM kernels (flash_attention,
ssd_scan) sum in another order than their plain versions and are held to
tests/test_kernels.py's tolerances: 3e-4 (attention) and 5e-4 (SSD) in
float32, 0.05 in bfloat16; bf16 attention and SSD, on either of their
routes (the tensor cores at attention's d 64 and 128 and the SSD's (dh,
ds) = (64, 128), the CUDA cores otherwise), also to one bf16 ulp
(chip_smoke.py's bf16_tol).  The MoE dispatch gather (a copy, or one
IEEE division and rounding per element) equals its plain version bit for
bit.  In training the three LM kernels run forward inside
``torch.autograd.Function``s whose backward is the plain version's VJP:
their gradients equal autograd of the plain version bit for bit.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dbscan, ddc  # noqa: E402
from repro_torch.data import spatial  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import contour_dist, flash_attention, ops, pairwise_dist, ref  # noqa: E402
from repro_torch.kernels import moe_gather, ssd_scan  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import engine, query_tier  # noqa: E402
from repro_torch import ddc as ddc_api  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _points(n, seed, cuda):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(n, 2)).astype(np.float32), device=cuda)
    mask = torch.as_tensor(rng.random(n) > 0.3, device=cuda)
    return rng, x, mask


@pytest.mark.parametrize("n,eps", [(1, 0.1), (255, 0.3), (256, 0.3), (1000, 0.1),
                                   (4097, 0.05), (32768, 0.02)])
def test_neighbor_count(cuda, n, eps):
    _, x, mask = _points(n, n, cuda)
    before = pairwise_dist.launches["neighbor_count"]
    got = pairwise_dist.neighbor_count(x, mask, eps)
    assert pairwise_dist.launches["neighbor_count"] == before + 1
    torch.testing.assert_close(got, ref.neighbor_count(x, mask, eps), rtol=0, atol=0)


# n = 1, ragged n, all rows masked, duplicate points, 32,768 points, and
# coordinates beyond the fold's bound at an infinite eps².
SYM_COUNT_CASES = [(1, 0.1, "normal"), (255, 0.3, "normal"), (1000, 0.1, "all_masked"),
                   (2048, 0.05, "duplicates"), (4097, 0.05, "normal"),
                   (32768, 0.02, "normal"), (3000, 1e20, "overflow")]


@pytest.mark.filterwarnings("ignore:overflow encountered")
@pytest.mark.parametrize("n,eps,kind", SYM_COUNT_CASES)
def test_neighbor_count_symmetric_kernel(cuda, n, eps, kind):
    """csrc/pair_sweep.cu's dense count: one launch counted, two launches
    bit-identical, equal to the plain version on every input."""
    x, mask, _, _ = _sweep_inputs(n, n + 9, kind, cuda)
    ops.reset_launch_counts()
    got = pairwise_dist.neighbor_count(x, mask, eps)
    assert pairwise_dist.launches["neighbor_count"] == 1
    assert torch.equal(got, pairwise_dist.neighbor_count(x, mask, eps))
    assert pairwise_dist.launches["neighbor_count"] == 2
    assert torch.equal(got, ref.neighbor_count(x, mask, eps))
    if kind == "all_masked":
        assert not bool(got.any())
    if kind == "overflow":  # the point beyond 2^62 does not count itself (d2 NaN)
        assert int(got[3]) == int(mask.sum()) - 1


@pytest.mark.parametrize("n,eps", [(1, 0.1), (255, 0.3), (1000, 0.1), (4097, 0.05),
                                   (32768, 0.02)])
def test_min_label_sweep(cuda, n, eps):
    rng, x, mask = _points(n, n + 1, cuda)
    labels = torch.as_tensor(rng.integers(0, n, n).astype(np.int32), device=cuda)
    labels[::7] = ref.SENTINEL
    core = torch.as_tensor(rng.random(n) > 0.5, device=cuda)
    got = pairwise_dist.min_label_sweep(x, mask, labels, core, eps)
    torch.testing.assert_close(got, ref.min_label_sweep(x, mask, labels, core, eps),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,m", [(1, 1), (1000, 7), (32768, 8), (4097, 300), (513, 256)])
def test_pairwise_dist_sq(cuda, n, m):
    """Ragged n, m below, at and above the block's 256 columns."""
    rng = np.random.default_rng(n * m)
    x = torch.as_tensor(rng.uniform(0, 1, (n, 2)).astype(np.float32), device=cuda)
    y = torch.as_tensor(rng.uniform(0, 1, (m, 2)).astype(np.float32), device=cuda)
    y[0] = x[0]  # a zero distance
    before = pairwise_dist.launches["pairwise_dist_sq"]
    got = pairwise_dist.pairwise_dist_sq(x, y)
    assert pairwise_dist.launches["pairwise_dist_sq"] == before + 1
    assert got.shape == (n, m) and torch.equal(got, ref.pairwise_dist_sq(x, y))
    assert float(got[0, 0]) == 0.0
    with pytest.raises(ValueError):
        pairwise_dist.pairwise_dist_sq(x, y.cpu())


def test_kmeans_kernel_run_equals_plain_run(cuda):
    """K-Means on the card: labels, centroids and inertia of the kernel
    run equal the plain run's bit for bit, from the same seed."""
    pts = torch.as_tensor(spatial.make_d2(32768, seed=1), device=cuda)
    mask = torch.ones(32768, dtype=torch.bool, device=cuda)
    from repro_torch.core import kmeans

    def run():
        return kmeans.kmeans(pts, mask, 8, generator=torch.Generator(device=cuda).manual_seed(0))

    before = pairwise_dist.launches["pairwise_dist_sq"]
    got = run()
    assert pairwise_dist.launches["pairwise_dist_sq"] == before + 26
    ops.FORCE = "ref"
    try:
        want = run()
    finally:
        ops.FORCE = None
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got, run()))


@pytest.mark.parametrize("schedule,refine", [("async", "grid"), ("tree", "grid"),
                                             ("tree", "fps")])
def test_schedules_card_equal_cpu(cuda, schedule, refine):
    make, eps, min_pts, grid, max_verts, max_clusters = spatial.PARITY_CASES["rings"]
    pts = make()
    cfg = ddc.DDCConfig(eps=eps, min_pts=min_pts, grid=grid, max_verts=max_verts,
                        max_clusters=max_clusters, schedule=schedule, merge_refine=refine,
                        block_sparse="never")
    mask = np.ones(len(pts), bool)
    meters = ddc.CommMeter(), ddc.CommMeter()
    on_card = ddc.make_ddc_fn(cfg, 8, meter=meters[0])(pts, mask)
    on_cpu = ddc.make_ddc_fn(cfg, 8, device="cpu", meter=meters[1])(pts, mask)
    for a, b in zip((on_card[0], *on_card[1], on_card[2]), (on_cpu[0], *on_cpu[1], on_cpu[2])):
        assert torch.equal(a.cpu(), b)
    assert meters[0].snapshot() == meters[1].snapshot()


@pytest.mark.parametrize("m,v", [(1, 16), (11, 16), (24, 8), (64, 128), (256, 128),
                                 (5, 300)])
def test_contour_min_d2(cuda, m, v):
    rng = np.random.default_rng(m * v)
    contours = torch.as_tensor(rng.uniform(0, 1, (m, v, 2)).astype(np.float32), device=cuda)
    counts = torch.as_tensor(rng.integers(0, v + 1, m).astype(np.int32), device=cuda)
    counts[0] = v
    valid = torch.as_tensor(rng.random(m) > 0.25, device=cuda)
    got = contour_dist.contour_min_d2(contours, counts, valid)
    want = ref.contour_min_d2(contours, counts, valid)
    assert torch.equal(got, want)


def _contour_side(rng, m, v, kind, cuda):
    contours = rng.uniform(0, 1, (m, v, 2)).astype(np.float32)
    counts = rng.integers(0, v + 1, m).astype(np.int32)
    valid = rng.random(m) > 0.25
    if kind == "invalid":          # every slot empty: all BIG, no item
        valid[:] = False
    elif kind == "one":            # one valid slot
        valid[:] = False
        valid[m // 2], counts[m // 2] = True, max(1, v // 3)
    elif kind == "full":           # no padding vertex anywhere: no BIG in any min
        counts[:], valid[:] = v, True
    elif kind == "ragged":         # counts past v and below 0 clamp as the plain version's
        counts[0], counts[-1] = v + 7, -3
        contours[1] = contours[0]  # duplicate slots: a zero distance
    return tuple(torch.as_tensor(a, device=cuda) for a in (contours, counts, valid))


@pytest.mark.parametrize("m,v,kind", [(256, 128, "invalid"), (256, 128, "one"),
                                      (64, 8, "ragged"), (40, 128, "full"), (17, 2048, "ragged"),
                                      (300, 16, "mixed"), (256, 128, "mixed")])
def test_contour_min_d2_valid_slots(cuda, m, v, kind):
    """B5's square form: only valid slots tested, each unordered pair once
    and written both ways; bit for bit the plain version, symmetric, and
    equal to the rectangular form of the same rows; two launches equal."""
    c, n, val = _contour_side(np.random.default_rng(m + v), m, v, kind, cuda)
    before = dict(contour_dist.launches)
    got = contour_dist.contour_min_d2(c, n, val)
    assert contour_dist.launches["contour_min_d2"] == before["contour_min_d2"] + 1
    assert torch.equal(got, ref.contour_min_d2(c, n, val))
    assert torch.equal(got, got.T) and torch.equal(got, contour_dist.contour_min_d2(c, n, val))
    rows = torch.arange(0, m, 3, device=cuda)
    rect = contour_dist.cross_min_d2(c[rows], n[rows], val[rows], c, n, val)
    assert contour_dist.launches["cross_min_d2"] == before["cross_min_d2"] + 1
    assert torch.equal(rect, got[rows])
    if kind == "invalid":
        assert bool((got == 1e30).all())


@pytest.mark.parametrize("m,valid_slots", [(29_000, 300), (29_000, 0)])
def test_contour_min_d2_staged_lists(cuda, m, valid_slots):
    """Slot lists past a block's shared memory (29,000 slots at v 128; a
    512-lane fold has 32,768) take the square form's staged entry: bit for
    bit the plain version, one main launch and one compaction launch
    counted.  The rectangular form has no staged entry and raises."""
    rng = np.random.default_rng(m + valid_slots)
    v = 128
    c, n, val = _contour_side(rng, m, v, "invalid", cuda)
    idx = torch.as_tensor(rng.choice(m, valid_slots, replace=False), device=cuda)
    val[idx] = True
    n[idx] = torch.as_tensor(rng.integers(1, 40, valid_slots).astype(np.int32), device=cuda)
    assert contour_dist._staged(v, m, cuda) is not None
    before = dict(contour_dist.launches)
    compacted = contour_dist.compact_launches["contour_min_d2"]
    got = contour_dist.contour_min_d2(c, n, val)
    assert contour_dist.launches["contour_min_d2"] == before["contour_min_d2"] + 1
    assert contour_dist.compact_launches["contour_min_d2"] == compacted + 1
    assert torch.equal(got, ref.contour_min_d2(c, n, val))
    del got
    rows = torch.cat([idx[:64], torch.arange(32, device=cuda)])
    with pytest.raises(ValueError, match="shared memory"):
        contour_dist.cross_min_d2(c[rows], n[rows], val[rows], c, n, val)
    assert contour_dist.launches["cross_min_d2"] == before["cross_min_d2"]


@pytest.mark.parametrize("a,b,v,kind_a,kind_b", [(96, 256, 128, "mixed", "mixed"),
                                                 (3, 300, 16, "one", "mixed"),
                                                 (50, 7, 2048, "ragged", "full"),
                                                 (20, 30, 8, "invalid", "mixed"),
                                                 (1, 1, 5, "full", "full")])
def test_cross_min_d2(cuda, a, b, v, kind_a, kind_b):
    """B5's rectangular form, A != B: bit for bit the plain version."""
    rng = np.random.default_rng(a * b + v)
    side_a = _contour_side(rng, a, v, kind_a, cuda)
    side_b = _contour_side(rng, b, v, kind_b, cuda)
    got = contour_dist.cross_min_d2(*side_a, *side_b)
    assert got.shape == (a, b)
    assert torch.equal(got, ref.cross_min_d2(*side_a, *side_b))
    assert torch.equal(got, ops.cross_min_d2(*side_a, *side_b))
    with pytest.raises(ValueError):
        contour_dist.cross_min_d2(*side_a, side_b[0].cpu(), *side_b[1:])
    with pytest.raises(ValueError):
        contour_dist.cross_min_d2(*side_a, side_b[0][:, :1].contiguous(), *side_b[1:])


@pytest.mark.parametrize("n,m", [(32768, 1), (32768, 3), (32768, 16), (257, 8), (255, 300),
                                 (77, 4), (300, 128), (4097, 2049), (100, 4100)])
def test_pairwise_dist_sq_rows(cuda, n, m):
    """B6's warp of 32 rows stored in order: k 4 to 128 (float4 stores,
    four columns a lane), k 1, 3, 300 and past a warp's 32 lanes (single
    floats), ragged n."""
    rng = np.random.default_rng(n + m)
    x = torch.as_tensor(rng.normal(size=(n, 2)).astype(np.float32), device=cuda)
    y = torch.as_tensor(rng.normal(size=(m, 2)).astype(np.float32), device=cuda)
    got = pairwise_dist.pairwise_dist_sq(x, y)
    assert torch.equal(got, ref.pairwise_dist_sq(x, y))
    assert torch.equal(got, pairwise_dist.pairwise_dist_sq(x, y))


def test_launch_floor_kernel(cuda):
    """The empty kernel builds and launches; other devices raise."""
    from repro_torch.kernels import launch_floor
    launch_floor.empty(cuda)
    torch.cuda.synchronize()
    with pytest.raises(ValueError):
        launch_floor.empty("cpu")


@pytest.mark.parametrize("dirty,exclude", [([1, 3, 6], None), ([3], None), ([1, 3, 6, 3], 5),
                                           ([], None)])
def test_merge_delta_card_equals_rebuild_and_cpu(cuda, dirty, exclude):
    """The delta merge on the card: patching a cached matrix (one
    rectangular launch) equals the rebuild bit for bit, in the matrix, the
    maps and the merged set, and equals the CPU run."""
    make, eps, min_pts, grid, max_verts, max_clusters = spatial.PARITY_CASES["rings"]
    cfg = ddc.DDCConfig(eps=eps, min_pts=min_pts, grid=grid, max_verts=max_verts,
                        max_clusters=max_clusters, block_sparse="never")
    mask = np.ones(2048, bool)
    traces = [{}, {}]
    ddc.make_ddc_fn(cfg, 8, device=cuda)(make(), mask, traces[0])
    ddc.make_ddc_fn(cfg, 8, device=cuda)(spatial.make_rings(2048, seed=7), mask, traces[1])
    old, other = traces[0]["batch"], traces[1]["batch"]
    batch = ddc.stack_clustersets([ddc.lane_set(other if i in dirty else old, i)
                                   for i in range(8)])
    cached = ddc.contour_pair_d2(old, cfg)
    ex = None
    if exclude is not None:
        ex = torch.zeros(8, dtype=torch.bool, device=cuda)
        ex[exclude] = True
    before = contour_dist.launches["cross_min_d2"]
    got = ddc.merge_delta(batch, cached.clone(), dirty, cfg, ex)
    assert contour_dist.launches["cross_min_d2"] == before + (1 if dirty else 0)
    rebuild = ddc.merge_delta(batch, None, None, cfg, ex)
    cpu_batch = ddc.ClusterSet(*(t.cpu() for t in batch))
    on_cpu = ddc.merge_delta(cpu_batch, cached.cpu(), dirty, cfg, None if ex is None else ex.cpu())
    for want in (rebuild, on_cpu):
        (gm, gmaps, gd2), (wm, wmaps, wd2) = got, want
        assert torch.equal(gd2.cpu(), wd2.cpu()) and torch.equal(gmaps.cpu(), wmaps.cpu())
        assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(gm, wm))


def _sorted_on_card(layout, n, bt, seed, cuda, empty_tile=False):
    rng = np.random.default_rng(seed)
    if layout == "one_cell":  # every tile pair active: frac = 1
        pts = (0.5 + rng.normal(0, 0.001, (n, 2))).astype(np.float32)
    elif layout == "clustered":
        pts = spatial.make_clustered(n, seed=seed)
    else:
        pts = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    # Ragged: masked rows in every tile.  They sort to the tail, so one_cell
    # masks fewer than a tile's worth, or whole tail tiles would be empty
    # and their pairs inactive.
    mask = rng.random(n) > (0.02 if layout == "one_cell" else 0.2)
    if empty_tile:
        mask[-bt:] = False  # after the sort, the last tile holds only masked rows
    x, m = torch.as_tensor(pts, device=cuda), torch.as_tensor(mask, device=cuda)
    sp, sm, _ = dbscan.spatial_sort(dbscan.center_points(x, m), m, bt)
    return sp.contiguous(), sm.contiguous()


SPARSE_CASES = [("clustered", 4096, 64, 0.02, False), ("clustered", 4096, 128, 0.03, True),
                ("random", 8192, 512, 0.01, False), ("clustered", 32768, 512, 0.005, True),
                ("one_cell", 2048, 128, 0.01, False), ("random", 1000, 64, 0.05, True)]


@pytest.mark.parametrize("layout,n,bt,eps,empty_tile", SPARSE_CASES)
def test_neighbor_count_sparse(cuda, layout, n, bt, eps, empty_tile):
    sp, sm = _sorted_on_card(layout, n, bt, n + bt, cuda, empty_tile)
    pairs = ops.build_tile_pairs(sp, sm, eps, bt=bt)
    if layout == "one_cell":
        assert float(pairs.frac) == 1.0
    before = pairwise_dist.launches["neighbor_count_sparse"]
    got = pairwise_dist.neighbor_count_sparse(sp, sm, eps, pairs, bt=bt)
    assert pairwise_dist.launches["neighbor_count_sparse"] == before + 1
    want = ref.neighbor_count_sparse(sp, sm, eps, pairs.rows, pairs.cols, pairs.flags, bt)
    assert torch.equal(got, want)
    assert torch.equal(got, ref.neighbor_count(sp, sm, eps))


# Every SPARSE_CASES tiling, then sub-tiles of 32 (bt 96), all rows masked,
# and duplicate points.
SYM_COUNT_SPARSE_CASES = [(*case, "normal") for case in SPARSE_CASES] + [
    ("clustered", 2048, 96, 0.05, False, "normal"),
    ("clustered", 4096, 128, 0.03, False, "all_masked"),
    ("clustered", 4096, 512, 0.01, True, "duplicates")]


@pytest.mark.parametrize("layout,n,bt,eps,empty_tile,kind", SYM_COUNT_SPARSE_CASES)
def test_neighbor_count_sparse_symmetric_kernel(cuda, layout, n, bt, eps, empty_tile, kind):
    """csrc/pair_sweep.cu's sparse count over the diagonal and the upper
    list: as the dense test, against the plain sparse version and the
    dense count."""
    if kind == "duplicates":
        rng = np.random.default_rng(n)
        pts = torch.as_tensor(spatial.make_clustered(n // 16, seed=n).repeat(16, axis=0),
                              device=cuda)
        m = torch.as_tensor(rng.random(n) > 0.2, device=cuda)
        sp, sm, _ = dbscan.spatial_sort(dbscan.center_points(pts, m), m, bt)
        sp, sm = sp.contiguous(), sm.contiguous()
    else:
        sp, sm = _sorted_on_card(layout, n, bt, n + bt + 3, cuda, empty_tile)
    if kind == "all_masked":
        sm = torch.zeros_like(sm)
    pairs = ops.build_tile_pairs(sp, sm, eps, bt=bt)
    ops.reset_launch_counts()
    got = pairwise_dist.neighbor_count_sparse(sp, sm, eps, pairs, bt=bt)
    assert pairwise_dist.launches["neighbor_count_sparse"] == 1
    assert torch.equal(got, pairwise_dist.neighbor_count_sparse(sp, sm, eps, pairs, bt=bt))
    assert pairwise_dist.launches["neighbor_count_sparse"] == 2
    want = ref.neighbor_count_sparse(sp, sm, eps, pairs.rows, pairs.cols, pairs.flags, bt)
    assert torch.equal(got, want)
    assert torch.equal(got, ref.neighbor_count(sp, sm, eps))
    if kind == "all_masked":
        assert not bool(got.any())


@pytest.mark.parametrize("layout,n,bt,eps,empty_tile", SPARSE_CASES)
def test_min_label_sweep_sparse(cuda, layout, n, bt, eps, empty_tile):
    sp, sm = _sorted_on_card(layout, n, bt, n + bt + 1, cuda, empty_tile)
    npad = sp.shape[0]
    rng = np.random.default_rng(npad)
    labels = torch.as_tensor(rng.integers(0, npad, npad).astype(np.int32), device=cuda)
    labels[::7] = ref.SENTINEL
    core = torch.as_tensor(rng.random(npad) > 0.5, device=cuda)
    pairs = ops.build_tile_pairs(sp, sm, eps, bt=bt)
    got = pairwise_dist.min_label_sweep_sparse(sp, sm, labels, core, eps, pairs, bt=bt)
    want = ref.min_label_sweep_sparse(sp, sm, labels, core, eps, pairs.rows, pairs.cols,
                                      pairs.flags, bt)
    assert torch.equal(got, want)
    assert torch.equal(got, ref.min_label_sweep(sp, sm, labels, core, eps))


def _sweep_inputs(n, seed, kind, cuda):
    """Points, mask, labels and core flags for a sweep.  ``kind``: "normal";
    "all_masked" (no row takes part); "no_core"; "big" (labels up to
    INT32_MAX, most above 2^30); "big_tile" (the first 256 points masked
    core points labelled above 2^30: their items take the exact path);
    "all_big" (every point so: with a wide eps every row's result is a
    label above 2^30); "overflow" (points up to |x| ≈ 4e17, one at 1.35e19
    whose |x|² overflows when doubled: its items take the exact path);
    "duplicates" (16 copies of each point)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2)).astype(np.float32)
    mask = rng.random(n) > (1.1 if kind == "all_masked" else 0.3)
    labels = rng.integers(0, n, n).astype(np.int32)
    labels[::7] = ref.SENTINEL
    core = rng.random(n) > (1.1 if kind == "no_core" else 0.5)
    big = rng.integers(ref.SENTINEL + 1, 2**31 - 1, n, endpoint=True).astype(np.int32)
    if kind == "big":
        labels = rng.integers(0, 2**31 - 1, n, endpoint=True).astype(np.int32)
    elif kind == "big_tile":
        labels[:256], mask[:256], core[:256] = big[:256], True, True
    elif kind == "all_big":
        labels, mask[:], core[:] = big, True, True
    elif kind == "duplicates":
        x = x[:n // 16].repeat(16, axis=0)
    elif kind == "overflow":
        x = (x * np.float32(1e17)).astype(np.float32)
        x[min(3, n - 1)] = (1.35e19, 0.0)
        labels[min(3, n - 1)], mask[min(3, n - 1)], core[min(3, n - 1)] = -1, True, True
    return tuple(torch.as_tensor(a, device=cuda) for a in (x, mask, labels, core))


# n = 1, ragged n, all rows masked, no core point, 32,768 points, labels
# above 2^30 (some, a whole tile, all), and coordinates beyond the fold's
# bound at an infinite eps².
SYM_DENSE_CASES = [(1, 0.1, "normal"), (255, 0.3, "normal"), (1000, 0.1, "all_masked"),
                   (4097, 0.05, "no_core"), (32768, 0.02, "normal"), (600, 0.2, "normal"),
                   (600, 0.3, "big"), (1000, 0.5, "big_tile"), (300, 100.0, "all_big"),
                   (3000, 1e20, "overflow")]


@pytest.mark.filterwarnings("ignore:overflow encountered")
@pytest.mark.parametrize("n,eps,kind", SYM_DENSE_CASES)
def test_min_label_sweep_symmetric_kernel(cuda, n, eps, kind):
    """csrc/pair_sweep.cu's dense sweep: one launch counted, two launches
    bit-identical, equal to the plain version on every input."""
    x, mask, labels, core = _sweep_inputs(n, n + 5, kind, cuda)
    ops.reset_launch_counts()
    got = pairwise_dist.min_label_sweep(x, mask, labels, core, eps)
    assert pairwise_dist.launches["min_label_sweep"] == 1
    assert torch.equal(got, pairwise_dist.min_label_sweep(x, mask, labels, core, eps))
    assert torch.equal(got, ref.min_label_sweep(x, mask, labels, core, eps))
    assert pairwise_dist.launches["min_label_sweep"] == 2
    if kind == "all_masked":
        assert bool((got == ref.SENTINEL).all())
    if kind == "all_big":
        assert bool((got > ref.SENTINEL).all())


# Every SPARSE_CASES tiling, then sub-tiles of 32 (bt 96), all rows masked,
# no core point, labels above 2^30, and a tile of them.
SYM_SPARSE_CASES = [(*case, "normal") for case in SPARSE_CASES] + [
    ("clustered", 2048, 96, 0.05, False, "normal"),
    ("clustered", 4096, 128, 0.03, False, "all_masked"),
    ("random", 8192, 512, 0.01, True, "no_core"),
    ("one_cell", 2048, 128, 0.01, False, "big"),
    ("clustered", 4096, 64, 0.05, False, "big_tile")]


@pytest.mark.parametrize("layout,n,bt,eps,empty_tile,kind", SYM_SPARSE_CASES)
def test_min_label_sweep_sparse_symmetric_kernel(cuda, layout, n, bt, eps, empty_tile, kind):
    """csrc/pair_sweep.cu's sparse sweep over the diagonal and the upper
    list: as the dense test, against the plain sparse version and the
    dense one capped at 2^30."""
    sp, sm = _sorted_on_card(layout, n, bt, n + bt + 2, cuda, empty_tile)
    npad = sp.shape[0]
    rng = np.random.default_rng(npad + 1)
    labels = torch.as_tensor(rng.integers(0, npad, npad).astype(np.int32), device=cuda)
    labels[::7] = ref.SENTINEL
    core = torch.as_tensor(rng.random(npad) > (1.1 if kind == "no_core" else 0.5), device=cuda)
    if kind == "all_masked":
        sm = torch.zeros_like(sm)
    elif kind == "big":
        labels = torch.as_tensor(rng.integers(0, 2**31 - 1, npad, endpoint=True)
                                 .astype(np.int32), device=cuda)
    elif kind == "big_tile":
        labels[:bt] = torch.as_tensor(rng.integers(ref.SENTINEL + 1, 2**31 - 1, bt)
                                      .astype(np.int32), device=cuda)
        sm[:bt] = True
        core[:bt] = True
    pairs = ops.build_tile_pairs(sp, sm, eps, bt=bt)
    ops.reset_launch_counts()
    got = pairwise_dist.min_label_sweep_sparse(sp, sm, labels, core, eps, pairs, bt=bt)
    assert pairwise_dist.launches["min_label_sweep_sparse"] == 1
    assert torch.equal(got, pairwise_dist.min_label_sweep_sparse(sp, sm, labels, core, eps,
                                                                 pairs, bt=bt))
    assert pairwise_dist.launches["min_label_sweep_sparse"] == 2
    want = ref.min_label_sweep_sparse(sp, sm, labels, core, eps, pairs.rows, pairs.cols,
                                      pairs.flags, bt)
    assert torch.equal(got, want)
    assert torch.equal(got, ref.min_label_sweep(sp, sm, labels, core, eps)
                       .clamp_max(ref.SENTINEL))


def test_sparse_sweep_needs_the_upper_list(cuda):
    """A tile-pair list without the upper list, or with another tiling's,
    raises ``ValueError``; nothing launches."""
    sp, sm = _sorted_on_card("clustered", 1024, 64, 3, cuda)
    pairs = ops.build_tile_pairs(sp, sm, 0.02, bt=64)
    lab = torch.arange(1024, dtype=torch.int32, device=cuda)
    old = types.SimpleNamespace(**{f: getattr(pairs, f) for f in (
        "rows", "cols", "flags", "n_active", "frac", "row_ptr")})
    ops.reset_launch_counts()
    for bad in (old, pairs._replace(up_rows=pairs.up_rows[:-1]),
                pairs._replace(n_up=pairs.n_up.long()),
                pairs._replace(up_cols=pairs.up_cols.cpu())):
        with pytest.raises(ValueError):
            pairwise_dist.min_label_sweep_sparse(sp, sm, lab, sm, 0.02, bad, bt=64)
    assert pairwise_dist.launches["min_label_sweep_sparse"] == 0


def test_sparse_count_needs_the_upper_list(cuda):
    """The count reads the upper list too: without it, or with another
    tiling's, it raises ``ValueError`` and nothing launches."""
    sp, sm = _sorted_on_card("clustered", 1024, 64, 3, cuda)
    pairs = ops.build_tile_pairs(sp, sm, 0.02, bt=64)
    old = types.SimpleNamespace(**{f: getattr(pairs, f) for f in (
        "rows", "cols", "flags", "n_active", "frac", "row_ptr")})
    ops.reset_launch_counts()
    for bad in (old, pairs._replace(up_rows=pairs.up_rows[:-1]),
                pairs._replace(n_up=pairs.n_up.long()),
                pairs._replace(up_cols=pairs.up_cols.cpu())):
        with pytest.raises(ValueError):
            pairwise_dist.neighbor_count_sparse(sp, sm, 0.02, bad, bt=64)
    assert pairwise_dist.launches["neighbor_count_sparse"] == 0


def test_sparse_kernels_reject_bad_inputs(cuda):
    sp, sm = _sorted_on_card("clustered", 1024, 64, 3, cuda)
    pairs = ops.build_tile_pairs(sp, sm, 0.02, bt=64)
    lab = torch.arange(1024, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # n not a multiple of bt
        pairwise_dist.neighbor_count_sparse(sp[:1000].contiguous(), sm[:1000].contiguous(),
                                            0.02, pairs, bt=64)
    with pytest.raises(ValueError):  # bt not a multiple of 32
        pairwise_dist.neighbor_count_sparse(sp, sm, 0.02, ops.build_tile_pairs(
            sp, sm, 0.02, bt=16), bt=16)
    with pytest.raises(ValueError):  # the pair list of another tiling
        pairwise_dist.neighbor_count_sparse(sp, sm, 0.02, pairs, bt=128)
    with pytest.raises(ValueError):  # wrong dtypes
        pairwise_dist.neighbor_count_sparse(sp, sm, 0.02, pairs._replace(
            up_rows=pairs.up_rows.long()), bt=64)
    with pytest.raises(ValueError):
        pairwise_dist.min_label_sweep_sparse(sp, sm, lab.long(), sm, 0.02, pairs, bt=64)
    with pytest.raises(ValueError):
        pairwise_dist.min_label_sweep_sparse(sp.double(), sm, lab, sm, 0.02, pairs, bt=64)


def test_kernels_reject_bad_inputs(cuda):
    x = torch.zeros((8, 3), device=cuda)
    mask = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        pairwise_dist.neighbor_count(x, mask, 0.1)
    with pytest.raises(ValueError):
        pairwise_dist.neighbor_count(torch.zeros((8, 2), device=cuda), mask.int(), 0.1)


def test_make_ddc_fn_card_equals_cpu(cuda):
    """The whole path on the card (kernels) equals the CPU run (plain
    versions) bit for bit."""
    make, eps, min_pts, grid, max_verts, max_clusters = spatial.PARITY_CASES["d2"]
    pts = make()
    cfg = ddc.DDCConfig(eps=eps, min_pts=min_pts, grid=grid, max_verts=max_verts,
                        max_clusters=max_clusters, schedule="sync", block_sparse="never")
    mask = np.ones(len(pts), bool)
    ops.reset_launch_counts()
    on_card = ddc.make_ddc_fn(cfg, 4)(pts, mask)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("neighbor_count", "min_label_sweep", "contour_min_d2"))
    on_cpu = ddc.make_ddc_fn(cfg, 4, device="cpu")(pts, mask)
    for a, b in zip((on_card[0], *on_card[1], on_card[2]), (on_cpu[0], *on_cpu[1], on_cpu[2])):
        assert torch.equal(a.cpu(), b)


def test_make_ddc_fn_default_config_card_equals_cpu(cuda):
    """The default configuration ("auto") takes the block-sparse path on
    the card and the dense path on the CPU; the two are bit-identical."""
    pts = spatial.make_clustered(8192, seed=0)
    mask = np.ones(len(pts), bool)
    cfg = ddc.DDCConfig(eps=0.02, min_pts=5, schedule="sync")
    ops.reset_launch_counts()
    trace: dict = {}
    on_card = ddc.make_ddc_fn(cfg, 2)(pts, mask, trace)
    counts = ops.launch_counts()
    assert [p["path"] for p in trace["paths"]] == ["sparse", "sparse"]
    assert counts["neighbor_count_sparse"] == 2 and counts["min_label_sweep_sparse"] > 2
    assert counts["neighbor_count"] == counts["min_label_sweep"] == 0
    on_cpu = ddc.make_ddc_fn(cfg, 2, device="cpu")(pts, mask)
    for a, b in zip((on_card[0], *on_card[1], on_card[2]), (on_cpu[0], *on_cpu[1], on_cpu[2])):
        assert torch.equal(a.cpu(), b)


# -- the LM kernels: flash_attention (B7) and ssd_scan (B8) --------------------

TOL = {torch.float32: (3e-4, 3e-4), torch.bfloat16: (0.05, 0.05)}
SSD_TOL = {torch.float32: (5e-4, 5e-4), torch.bfloat16: (0.05, 0.05)}


def _randn(rng, shape, cuda, dtype=torch.float32):
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=cuda).to(dtype)


# tests/test_kernels.py's TestFlashAttention shapes, then ragged lengths,
# decode (sq = 1), odd and extreme head dims, and qwen3-8b's GQA in bf16;
# then the tensor-core route (bf16 at d 64, 96 and 128): GQA, MQA, non-causal,
# windowed, ragged sq and skv (not multiples of its 128-row tiles), sq < 64,
# one query against a cache, and layers.gqa_qkv's (b, s, h, d) views.
FLASH_CASES = [
    # b, h, hkv, sq, skv, d, causal, window, dtype, route
    (1, 4, 4, 128, 128, 32, True, None, torch.float32, "simt"),      # MHA square
    (2, 8, 2, 128, 256, 64, True, None, torch.float32, "simt"),      # GQA, kv > q
    (1, 4, 1, 256, 256, 32, True, None, torch.float32, "simt"),      # MQA
    (2, 2, 2, 64, 64, 128, True, None, torch.float32, "simt"),       # large head dim
    (1, 2, 2, 128, 128, 32, False, None, torch.float32, "simt"),     # non-causal
    (1, 2, 2, 192, 192, 32, True, 32, torch.float32, "simt"),        # windowed
    (1, 2, 2, 192, 192, 32, True, 100, torch.float32, "simt"),
    (1, 2, 2, 128, 128, 32, True, None, torch.bfloat16, "simt"),     # bf16 at d 32
    (1, 4, 2, 100, 173, 64, True, None, torch.float32, "simt"),      # ragged sq and skv
    (2, 4, 4, 1, 77, 128, True, None, torch.float32, "simt"),        # one decode query
    (1, 3, 1, 45, 45, 80, False, 7, torch.float32, "simt"),          # d between buckets
    (1, 2, 2, 33, 70, 16, True, None, torch.float32, "simt"),        # smallest bucket
    (1, 2, 1, 65, 65, 256, True, None, torch.float32, "simt"),       # largest bucket
    (1, 32, 8, 300, 300, 128, True, None, torch.bfloat16, "tc"),     # qwen3-8b heads
    (2, 8, 2, 128, 256, 128, True, None, torch.bfloat16, "tc"),      # GQA, kv > q
    (1, 4, 1, 256, 256, 64, True, None, torch.bfloat16, "tc"),       # MQA
    (1, 2, 2, 128, 128, 128, False, None, torch.bfloat16, "tc"),     # non-causal
    (1, 2, 2, 192, 192, 64, True, 32, torch.bfloat16, "tc"),         # windowed
    (1, 2, 2, 300, 300, 128, True, 100, torch.bfloat16, "tc"),       # window across tiles
    (1, 4, 2, 100, 173, 128, True, None, torch.bfloat16, "tc"),      # ragged sq and skv
    (1, 4, 2, 200, 333, 64, False, None, torch.bfloat16, "tc"),      # ragged, non-causal
    (1, 4, 4, 33, 70, 128, True, None, torch.bfloat16, "tc"),        # sq < 64
    (2, 8, 2, 1, 300, 128, True, None, torch.bfloat16, "tc"),        # one query, a cache
    (1, 4, 4, 1, 77, 64, True, None, torch.bfloat16, "tc"),
    # MLA's qk dim of 96 (nope 64 + rope 32): the tensor cores in bf16 (a
    # tile of two 64-column atoms, the last 32 columns TMA's zeros), the CUDA
    # cores in float32
    (2, 8, 8, 200, 200, 96, True, None, torch.bfloat16, "tc"),
    (1, 4, 4, 130, 130, 96, True, None, torch.float32, "simt"),
    # whisper at d 64: the encoder's 1,500 frames, cross-attention in prefill
    # (2,048 queries against 1,500 keys) and in decode (one query), non-causal
    (1, 4, 4, 1500, 1500, 64, False, None, torch.bfloat16, "tc"),
    (1, 4, 4, 2048, 1500, 64, False, None, torch.bfloat16, "tc"),
    (4, 12, 12, 1, 1500, 64, False, None, torch.bfloat16, "tc"),
    # MLA's d 96 on the tensor cores: ragged sq and skv; GQA, a window across tiles
    (1, 4, 4, 100, 173, 96, True, None, torch.bfloat16, "tc"),
    (1, 8, 2, 300, 300, 96, True, 100, torch.bfloat16, "tc"),
]


def _bf16_one_ulp(got, want):
    """chip_smoke.py's bf16_tol: rtol 2^-7, atol 2^-12 max|want|."""
    atol = 2.0 ** -12 * float(want.double().abs().max())
    assert ((got.double() - want.double()).abs() <= atol + 2.0 ** -7 * want.double().abs()).all()


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,window,dtype,route", FLASH_CASES)
def test_flash_attention(cuda, b, h, hkv, sq, skv, d, causal, window, dtype, route):
    rng = np.random.default_rng(sq * skv + d)
    q = _randn(rng, (b, h, sq, d), cuda, dtype)
    k = _randn(rng, (b, hkv, skv, d), cuda, dtype)
    v = _randn(rng, (b, hkv, skv, d), cuda, dtype)
    assert flash_attention.route(dtype, d) == route
    before = flash_attention.launches["flash_attention"]
    routes = dict(flash_attention.route_launches)
    got = flash_attention.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches["flash_attention"] == before + 1
    assert flash_attention.route_launches[route] == routes[route] + 1
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == want.shape
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        _bf16_one_ulp(got, want)
    # Deterministic: no atomics, a fixed order of every sum.
    assert torch.equal(got, flash_attention.flash_attention(q, k, v, causal=causal,
                                                            window=window))


# B7 on the heads a rank computes under tensor parallelism
# (``layers.attn_heads``): qwen3-8b's 32/8 heads over model 2 and 4,
# llama4-scout's 40/8 over model 2 (kv heads not the rank's shard at 8:
# 5 query heads, each its own kv head), MQA's one kv head shared.
FLASH_LOCAL_CASES = [
    # b, h_local, kv_local, s, d, dtype
    (1, 16, 4, 2048, 128, torch.float32),
    (1, 8, 2, 2048, 128, torch.bfloat16),
    (2, 20, 4, 1024, 128, torch.bfloat16),
    (1, 5, 5, 512, 128, torch.float32),
    (1, 4, 1, 700, 64, torch.bfloat16),
]


@pytest.mark.parametrize("b,h,hkv,s,d,dtype", FLASH_LOCAL_CASES)
def test_flash_attention_local_heads(cuda, b, h, hkv, s, d, dtype):
    """One launch on the rank's heads, held to the plain attention (one
    bf16 ulp in bf16), on the projections' (b, s, heads, d) views as the
    layer hands them over."""
    rng = np.random.default_rng(h * s + hkv)
    q = _randn(rng, (b, s, h, d), cuda, dtype).transpose(1, 2)
    k = _randn(rng, (b, s, hkv, d), cuda, dtype).transpose(1, 2)
    v = _randn(rng, (b, s, hkv, d), cuda, dtype).transpose(1, 2)
    before = flash_attention.launches["flash_attention"]
    got = flash_attention.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches["flash_attention"] == before + 1
    want = ref.flash_attention(q, k, v, causal=True)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        _bf16_one_ulp(got, want)


def test_flash_attention_strided_inputs(cuda):
    """The model hands over transposed (b, s, h, d) views: no copy needed."""
    rng = np.random.default_rng(5)
    q = _randn(rng, (2, 40, 8, 64), cuda).transpose(1, 2)
    k = _randn(rng, (2, 40, 2, 64), cuda).transpose(1, 2)
    v = _randn(rng, (2, 40, 2, 64), cuda).transpose(1, 2)
    got = ops.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(got, ref.flash_attention(q, k, v), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("b,h,hkv,s,d,window", [(2, 32, 8, 200, 128, None),
                                                (1, 4, 2, 150, 64, 64)])
def test_flash_attention_tensor_cores_strided_inputs(cuda, b, h, hkv, s, d, window):
    """The tensor-core route reads gqa_qkv's (b, s, h, d) views in place
    (TMA maps over their strides)."""
    rng = np.random.default_rng(s + d)
    q = _randn(rng, (b, s, h, d), cuda, torch.bfloat16).transpose(1, 2)
    k = _randn(rng, (b, s, hkv, d), cuda, torch.bfloat16).transpose(1, 2)
    v = _randn(rng, (b, s, hkv, d), cuda, torch.bfloat16).transpose(1, 2)
    before = flash_attention.route_launches["tc"]
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    assert flash_attention.route_launches["tc"] == before + 1
    want = ref.flash_attention(q, k, v, causal=True, window=window)
    _bf16_one_ulp(got, want)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=True, window=window))


@pytest.mark.parametrize("sq", [2048, 1])
def test_flash_attention_cross_kv_views(cuda, sq):
    """Cross-attention reads ``layers.cross_kv``'s views of the encoder
    output's projections (b, Fs, kv·hd seen as (b, kv, Fs, hd)) and a query
    view of 2,048 rows (prefill) or one (decode), non-causal, on the
    tensor cores."""
    rng = np.random.default_rng(sq)
    b, h, fs, d = 2, 12, 1500, 64
    q = _randn(rng, (b, sq, h * d), cuda, torch.bfloat16).reshape(b, sq, h, d).transpose(1, 2)
    k = _randn(rng, (b, fs, h * d), cuda, torch.bfloat16).reshape(b, fs, h, d).transpose(1, 2)
    v = _randn(rng, (b, fs, h * d), cuda, torch.bfloat16).reshape(b, fs, h, d).transpose(1, 2)
    before = flash_attention.route_launches["tc"]
    got = ops.flash_attention(q, k, v, causal=False)
    assert flash_attention.route_launches["tc"] == before + 1
    _bf16_one_ulp(got, ref.flash_attention(q, k, v, causal=False))
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_mla_padded_v(cuda, dtype):
    """``layers.mla_apply`` pads v from 64 to the qk dim of 96 with zeros
    and cuts the output back: the kernel's first 64 columns equal exact
    attention over the unpadded v at the same scale, 1/√96."""
    rng = np.random.default_rng(96)
    q = _randn(rng, (2, 8, 150, 96), cuda, dtype)
    k = _randn(rng, (2, 8, 150, 96), cuda, dtype)
    v = _randn(rng, (2, 8, 150, 64), cuda, dtype)
    scale = 1.0 / 96 ** 0.5
    got = ops.flash_attention(q, k, torch.nn.functional.pad(v, (0, 32)), scale=scale)
    want = ref.flash_attention(q, k, v, scale=scale)
    assert not got[..., 64:].any()
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got[..., :64].float(), want.float(), rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        _bf16_one_ulp(got[..., :64], want)


def test_flash_attention_long_matches_chunked_route(cuda):
    """At sq·skv > 2**21 the plain route is the chunked version."""
    rng = np.random.default_rng(7)
    q = _randn(rng, (1, 4, 1536, 64), cuda, torch.bfloat16)
    k = _randn(rng, (1, 2, 1536, 64), cuda, torch.bfloat16)
    v = _randn(rng, (1, 2, 1536, 64), cuda, torch.bfloat16)
    got = ops.flash_attention(q, k, v)
    want = ref.flash_attention_chunked(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.05, atol=0.05)


def test_flash_attention_rejects_bad_inputs(cuda):
    q = torch.zeros((1, 4, 8, 32), device=cuda)
    k = torch.zeros((1, 2, 8, 32), device=cuda)
    with pytest.raises(ValueError):  # k on another device
        flash_attention.flash_attention(q, k.cpu(), k)
    with pytest.raises(ValueError):  # float16
        flash_attention.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):  # mixed dtypes
        flash_attention.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError):  # rank 3
        flash_attention.flash_attention(q[0], k[0], k[0])
    with pytest.raises(ValueError):  # unequal q/v head dims (MLA): no plain fallback
        ops.flash_attention(q, k, torch.zeros((1, 2, 8, 16), device=cuda))
    with pytest.raises(ValueError):  # head dim below the smallest bucket
        flash_attention.flash_attention(q[..., :8], k[..., :8], k[..., :8])
    with pytest.raises(ValueError):  # heads not a multiple of kv heads
        flash_attention.flash_attention(q[:, :3], k, k)
    with pytest.raises(ValueError):  # a zero window
        flash_attention.flash_attention(q, k, k, window=0)
    with pytest.raises(ValueError):  # a strided last axis
        flash_attention.flash_attention(q, k, torch.zeros((1, 2, 8, 64), device=cuda)[..., ::2])
    qb = torch.zeros((1, 4, 8, 136), device=cuda, dtype=torch.bfloat16)
    kb = torch.zeros((1, 2, 8, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # the tensor-core route: q off a 16-byte boundary
        flash_attention.flash_attention(qb[..., 1:129], kb, kb)


# tests/test_kernels.py's TestSSDScan shapes (its l = 100 case too), then
# ragged chunks, mamba2-1.3b's head (dh 64, ds 128) and bf16 off the tensor
# cores; then the tensor-core route (bf16 at dh 64, ds 128): a ragged l (not
# a multiple of its 64-step chunks), l < 64, l = 1, one whole chunk, b > 1.
SSD_CASES = [
    # b, l, h, dh, ds, dtype, route
    (1, 64, 2, 16, 8, torch.float32, "simt"),
    (2, 128, 3, 16, 8, torch.float32, "simt"),
    (1, 256, 1, 32, 16, torch.float32, "simt"),
    (2, 96, 4, 8, 4, torch.float32, "simt"),
    (2, 100, 3, 16, 8, torch.float32, "simt"),
    (1, 1, 2, 16, 8, torch.float32, "simt"),
    (1, 333, 4, 64, 128, torch.float32, "simt"),
    (2, 70, 3, 40, 256, torch.float32, "simt"),
    (2, 100, 3, 16, 8, torch.bfloat16, "simt"),
    (1, 70, 2, 64, 256, torch.bfloat16, "simt"),
    (1, 300, 4, 64, 128, torch.bfloat16, "tc"),
    (1, 50, 2, 64, 128, torch.bfloat16, "tc"),
    (1, 1, 2, 64, 128, torch.bfloat16, "tc"),
    (1, 64, 3, 64, 128, torch.bfloat16, "tc"),
    (3, 200, 2, 64, 128, torch.bfloat16, "tc"),
]


def _ssd_inputs(rng, b, l, h, dh, ds, cuda, dtype):
    x = _randn(rng, (b, l, h, dh), cuda, dtype)
    a = torch.as_tensor(-np.abs(rng.normal(size=(b, l, h))).astype(np.float32) * 0.1,
                        device=cuda)
    bb = _randn(rng, (b, l, h, ds), cuda, dtype)
    c = _randn(rng, (b, l, h, ds), cuda, dtype)
    return x, a, bb, c


@pytest.mark.parametrize("b,l,h,dh,ds,dtype,route", SSD_CASES)
def test_ssd_scan(cuda, b, l, h, dh, ds, dtype, route):
    rng = np.random.default_rng(l * h + ds)
    x, a, bb, c = _ssd_inputs(rng, b, l, h, dh, ds, cuda, dtype)
    assert ssd_scan.route(dtype, dh, ds) == route
    before = ssd_scan.launches["ssd_scan"]
    routes = dict(ssd_scan.route_launches)
    got = ssd_scan.ssd_scan(x, a, bb, c)
    torch.cuda.synchronize()
    assert ssd_scan.launches["ssd_scan"] == before + 1
    assert ssd_scan.route_launches[route] == routes[route] + 1
    want = ref.ssd_scan(x, a, bb, c)
    assert got.dtype == dtype and got.shape == want.shape
    rtol, atol = SSD_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        _bf16_one_ulp(got, want)
    # Deterministic: no atomics, a fixed order of every sum.
    assert torch.equal(got, ssd_scan.ssd_scan(x, a, bb, c))


def test_ssd_scan_broadcast_and_strided_inputs(cuda):
    """The Mamba layer passes x as a reshaped slice and c as a broadcast
    over heads (stride 0): the kernel reads both without a copy."""
    rng = np.random.default_rng(9)
    b, l, h, dh, ds = 2, 150, 4, 32, 16
    xbc = _randn(rng, (b, l, h * dh + 2 * ds), cuda)
    x = xbc[..., :h * dh].reshape(b, l, h, dh)
    c = xbc[..., h * dh + ds:][:, :, None, :].expand(b, l, h, ds)
    bb = xbc[..., h * dh:h * dh + ds][:, :, None, :].expand(b, l, h, ds) * 0.5
    a = torch.as_tensor(-np.abs(rng.normal(size=(b, l, h))).astype(np.float32) * 0.1,
                        device=cuda)
    got = ops.ssd_scan(x, a, bb, c)
    torch.testing.assert_close(got, ref.ssd_scan(x, a, bb, c), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("b,l,h", [(2, 150, 4), (1, 1000, 2), (3, 40, 1)])
def test_ssd_scan_tensor_cores_strided_inputs(cuda, b, l, h):
    """The tensor-core route reads the Mamba layer's views in place: x a
    reshaped slice of the conv output, b materialised, c broadcast over
    the heads (stride 0, a TMA map over (batch, step, ds))."""
    rng = np.random.default_rng(l + h)
    dh, ds = 64, 128
    xbc = _randn(rng, (b, l, h * dh + 2 * ds), cuda, torch.bfloat16)
    x = xbc[..., :h * dh].reshape(b, l, h, dh)
    c = xbc[..., h * dh + ds:][:, :, None, :].expand(b, l, h, ds)
    dt = torch.as_tensor(rng.uniform(0.01, 0.5, (b, l, h)).astype(np.float32), device=cuda)
    bb = (xbc[..., h * dh:h * dh + ds][:, :, None, :] * dt[..., None]).to(torch.bfloat16)
    a = -0.7 * dt
    before = ssd_scan.route_launches["tc"]
    got = ops.ssd_scan(x, a, bb, c)
    assert ssd_scan.route_launches["tc"] == before + 1
    _bf16_one_ulp(got, ref.ssd_scan(x, a, bb, c))
    assert torch.equal(got, ops.ssd_scan(x, a, bb, c))


def test_ssd_scan_rejects_bad_inputs(cuda):
    rng = np.random.default_rng(1)
    x, a, bb, c = _ssd_inputs(rng, 1, 16, 2, 8, 4, cuda, torch.float32)
    with pytest.raises(ValueError):  # a on the CPU
        ssd_scan.ssd_scan(x, a.cpu(), bb, c)
    with pytest.raises(ValueError):  # a not float32
        ssd_scan.ssd_scan(x, a.bfloat16(), bb, c)
    with pytest.raises(ValueError):  # float16 x
        ssd_scan.ssd_scan(x.half(), a, bb.half(), c.half())
    with pytest.raises(ValueError):  # rank
        ssd_scan.ssd_scan(x[0], a[0], bb[0], c[0])
    with pytest.raises(ValueError):  # shapes disagree
        ssd_scan.ssd_scan(x, a, bb, c[:, :8])
    with pytest.raises(ValueError):  # state larger than the kernel covers
        big = torch.zeros((1, 16, 2, 300), device=cuda)
        ssd_scan.ssd_scan(x, a, big, big)
    with pytest.raises(ValueError):  # state not a multiple of 4
        odd = torch.zeros((1, 16, 2, 6), device=cuda)
        ssd_scan.ssd_scan(x, a, odd, odd)
    with pytest.raises(ValueError):  # a strided last axis
        ssd_scan.ssd_scan(x, a, bb, torch.zeros((1, 16, 2, 8), device=cuda)[..., ::2])
    xb = torch.zeros((1, 16, 2, 68), device=cuda, dtype=torch.bfloat16)
    bc = torch.zeros((1, 16, 2, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # the tensor-core route: x's head stride not 16 bytes
        ssd_scan.ssd_scan(xb[..., :64], a, bc, bc)


# The kernels each tiny model launches in one greedy generation of 6
# tokens: attention and SSD once per layer in prefill (whisper's 2 encoder
# layers and 2 cross-attentions too), whisper's cross-attention once per
# decoder layer in each decode step, the MoE gather once per MoE layer in
# prefill and each decode step; jamba runs all three LM kernels.
SERVING_KERNELS = {
    "qwen3-8b": {"flash_attention": 2},
    "mamba2-1.3b": {"ssd_scan": 2},
    "llama4-scout-17b-a16e": {"flash_attention": 2, "dispatch_gather": 12},
    "minicpm3-4b": {"flash_attention": 2},
    "whisper-small": {"flash_attention": 2 + 2 + 2 * 6},
    "internvl2-26b": {"flash_attention": 2},
    "kimi-k2-1t-a32b": {"flash_attention": 2, "dispatch_gather": 12},
    "jamba-1.5-large-398b": {"flash_attention": 2, "ssd_scan": 14, "dispatch_gather": 12},
}


@pytest.mark.parametrize("arch", list(SERVING_KERNELS))
def test_serving_path_card_equals_cpu(cuda, arch):
    """The tiny configuration's greedy generation on the card (kernels in
    prefill, cross-attention and the MoE gather in decode too) against the
    CPU (plain versions), float32, with its frames or prefix: the launches
    of its plan, logits within 1e-4 and the same tokens."""
    cfg = configs.get_config(arch).tiny()
    model = T.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(3)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 40)))
    extras = {}
    if cfg.encoder_layers:
        extras["frames"] = torch.as_tensor(
            rng.normal(size=(2, cfg.frontend_seq, cfg.d_model)).astype(np.float32) * 0.1)
    if cfg.prefix_len:
        extras["prefix"] = torch.as_tensor(
            rng.normal(size=(2, cfg.prefix_len, cfg.d_model)).astype(np.float32) * 0.1)
    scfg = engine.ServeConfig(max_len=48 + cfg.prefix_len)
    tr_cpu: dict = {}
    want = engine.greedy_generate(cfg, model, prompt, 6, scfg, trace=tr_cpu, **extras)
    model_gpu = model.to(cuda)
    ops.reset_launch_counts()
    tr_gpu: dict = {}
    got = engine.greedy_generate(cfg, model_gpu, prompt.to(cuda), 6, scfg, trace=tr_gpu,
                                 **{k: v.to(cuda) for k, v in extras.items()})
    counts = ops.launch_counts()
    assert {k: n for k, n in counts.items() if n} == SERVING_KERNELS[arch]
    for lg, lc in zip(tr_gpu["logits"], tr_cpu["logits"]):
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    assert torch.equal(got.cpu(), want)


# -- the MoE dispatch gather (B9) -------------------------------------------------

GATHER_CASES = [
    # t, d, s, dtype, layout
    (64, 16, 256, torch.float32, "rows"),           # tests/test_moe_gather.py's shapes
    (128, 32, 128, torch.float32, "rows"),
    (32, 8, 512, torch.float32, "rows"),
    (64, 16, 128, torch.bfloat16, "rows"),
    (8, 4, 32, torch.float32, "empty"),             # every slot empty
    (50, 13, 77, torch.float32, "beyond"),          # ids >= t: empty slots too
    (50, 13, 77, torch.float32, "rows"),            # rows not 16-byte multiples
    (50, 13, 77, torch.bfloat16, "rows"),
    (40, 24, 60, torch.bfloat16, "strided"),        # a row-strided view of x
    (40, 24, 60, torch.float32, "strided"),
    (4, 5120, 16, torch.bfloat16, "rows"),          # llama4-scout's decode shape
    (8192, 5120, 10240, torch.bfloat16, "rows"),    # and its prefill shape
    (4, 7168, 384, torch.bfloat16, "rows"),         # kimi-k2 (E 384, top-8): decode,
    (8192, 7168, 82176, torch.bfloat16, "rows"),    # and prefill at capacity 214
    (8192, 8192, 20480, torch.bfloat16, "rows"),    # jamba's prefill (E 16, top-2)
]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("t,d,s,dtype,layout", GATHER_CASES)
def test_dispatch_gather(cuda, t, d, s, dtype, layout, quant):
    """One launch, bit-equal to the plain version on the card and on the
    CPU, and to a second launch."""
    g = torch.Generator(device=cuda).manual_seed(t * d + s)
    wide = torch.randn((t, 2 * d + 3), generator=g, device=cuda).to(dtype)
    x = wide[:, 3:3 + d] if layout == "strided" else wide[:, :d].contiguous()
    idx = torch.randint(-1, t, (s,), generator=g, device=cuda, dtype=torch.int32)
    if layout == "empty":
        idx.fill_(-1)
    elif layout == "beyond":
        idx = torch.randint(-1, 2 * t, (s,), generator=g, device=cuda, dtype=torch.int32)
        assert int(idx.max()) >= t
    before = moe_gather.launches["dispatch_gather"]
    buf, scales = moe_gather.dispatch_gather(x, idx, quant=quant)
    torch.cuda.synchronize()
    assert moe_gather.launches["dispatch_gather"] == before + 1
    want_buf, want_scales = ref.dispatch_gather(x, idx, quant=quant)
    cpu_buf, cpu_scales = ref.dispatch_gather(x.cpu(), idx.cpu(), quant=quant)
    assert buf.dtype == (torch.int8 if quant else dtype) and scales.dtype == torch.float32
    for got, want in ((buf, want_buf), (scales, want_scales), (buf.cpu(), cpu_buf),
                      (scales.cpu(), cpu_scales)):
        assert torch.equal(got, want)
    again = moe_gather.dispatch_gather(x, idx, quant=quant)
    assert torch.equal(again[0], buf) and torch.equal(again[1], scales)


# The a2a island's send buffer: D lanes of cap slots, whole lanes of −1
# (no copy routed there), at tiny and at llama4-scout's full-width shape
# on (data 2, model 2) (4,096 local tokens, top-1: cap 2,560 a lane).
A2A_SEND_CASES = [
    # t, d, lanes, cap, empty lanes, dtype
    (64, 16, 4, 24, (1, 3), torch.float32),
    (64, 16, 2, 40, (0,), torch.bfloat16),
    (4096, 5120, 2, 2560, (1,), torch.float32),
    (4096, 5120, 2, 2560, (1,), torch.bfloat16),
]


@pytest.mark.parametrize("t,d,lanes,cap,empty,dtype", A2A_SEND_CASES)
def test_dispatch_gather_int8_whole_empty_lanes(cuda, t, d, lanes, cap, empty, dtype):
    """B9's int8 mode on an a2a send buffer whose lanes are wholly −1: one
    launch, rows and scales bit-equal to the plain version; every slot of
    an empty lane int8 0 with scale 0 (it dequantises to 0)."""
    g = torch.Generator(device=cuda).manual_seed(t + cap)
    x = torch.randn((t, d), generator=g, device=cuda).to(dtype)
    idx = torch.randint(-1, t, (lanes, cap), generator=g, device=cuda, dtype=torch.int32)
    for lane in empty:
        idx[lane] = -1
    idx = idx.reshape(-1)
    before = moe_gather.launches["dispatch_gather"]
    q, scales = moe_gather.dispatch_gather(x, idx, quant=True)
    torch.cuda.synchronize()
    assert moe_gather.launches["dispatch_gather"] == before + 1
    want_q, want_s = ref.dispatch_gather(x, idx, quant=True)
    assert torch.equal(q, want_q) and torch.equal(scales, want_s)
    for lane in empty:
        assert (q.view(lanes, cap, d)[lane] == 0).all()
        assert (scales.view(lanes, cap)[lane] == 0).all()


def test_dispatch_gather_rejects_bad_inputs(cuda):
    x = torch.zeros((8, 16), device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # float16
        moe_gather.dispatch_gather(x.half(), idx, quant=False)
    with pytest.raises(ValueError):  # int64 ids
        moe_gather.dispatch_gather(x, idx.long(), quant=False)
    with pytest.raises(ValueError):  # a strided last axis
        moe_gather.dispatch_gather(x[:, ::2], idx, quant=True)
    with pytest.raises(ValueError):  # not (t, d)
        moe_gather.dispatch_gather(x[None], idx, quant=False)
    with pytest.raises(ValueError):  # ids on another device
        moe_gather.dispatch_gather(x, idx.cpu(), quant=False)


# -- training: the LM kernels as torch.autograd.Functions -------------------------
# A call that needs a gradient launches the kernel forward (one launch, on
# the route of its dtype and shape, equal to the plain version as above)
# and, in the backward pass, the plain version's VJP on the saved inputs:
# its gradients equal autograd of the plain version on the same inputs and
# cotangent, bit for bit, and the backward launches no kernel.

GRAD_FLASH_CASES = [
    # b, h, hkv, s, d, causal, window, dtype, route, layout
    (2, 8, 2, 300, 128, True, None, torch.bfloat16, "tc", "bhsd"),    # GQA, causal
    (1, 4, 2, 200, 64, True, 64, torch.bfloat16, "tc", "bshd"),       # window, gqa_qkv views
    (2, 8, 2, 300, 128, True, None, torch.float32, "simt", "bhsd"),
    (1, 4, 4, 200, 64, False, 50, torch.float32, "simt", "bhsd"),     # non-causal window
    (2, 4, 4, 256, 96, True, None, torch.bfloat16, "tc", "mla"),      # MLA: v 64 padded to 96
    (2, 4, 4, 256, 96, True, None, torch.float32, "simt", "mla"),
    (1, 4, 2, 1600, 64, True, None, torch.float32, "simt", "bhsd"),   # chunked recompute
]


def _grad_inputs(rng, shapes, cuda, dtype):
    return [_randn(rng, s, cuda, dtype).requires_grad_(True) for s in shapes]


def _grads(out, inputs, g):
    return torch.autograd.grad(out, inputs, g)


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window,dtype,route,layout", GRAD_FLASH_CASES)
def test_flash_attention_backward_is_the_plain_vjp(cuda, b, h, hkv, s, d, causal, window,
                                                   dtype, route, layout):
    rng = np.random.default_rng(s + d)
    dv = 64 if layout == "mla" else d
    if layout == "bshd":
        base = _grad_inputs(rng, [(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)], cuda, dtype)

        def views(q, k, v):
            return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    else:
        base = _grad_inputs(rng, [(b, h, s, d), (b, hkv, s, d), (b, hkv, s, dv)], cuda, dtype)

        def views(q, k, v):
            return q, k, (torch.nn.functional.pad(v, (0, d - dv)) if dv < d else v)
    kw = dict(causal=causal, window=window, scale=1.0 / d ** 0.5)

    def kernel(*t):
        return ops.flash_attention(*views(*t), **kw)[..., :dv]

    def plain(*t):
        return ops._plain_attention(*views(*t), kw["causal"], kw["scale"], kw["window"])[
            ..., :dv]

    assert flash_attention.route(dtype, d) == route
    ops.reset_launch_counts()
    got = kernel(*base)
    assert got.requires_grad
    assert flash_attention.route_launches == {**{"tc": 0, "simt": 0}, route: 1}
    want = plain(*base)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        _bf16_one_ulp(got.detach(), want.detach())
    g = _randn(rng, tuple(got.shape), cuda, dtype)
    got_g = _grads(got, base, g)
    assert flash_attention.launches["flash_attention"] == 1    # none in the backward
    for a, w in zip(got_g, _grads(want, base, g)):
        assert a.dtype == dtype and torch.equal(a, w)
    with torch.no_grad():   # without a gradient: the serving path, one launch
        assert torch.equal(kernel(*base), got.detach())
    assert flash_attention.launches["flash_attention"] == 2


@pytest.mark.parametrize("b,l,h,dh,ds,dtype,route", [
    (2, 300, 4, 64, 128, torch.bfloat16, "tc"),
    (2, 300, 4, 64, 128, torch.float32, "simt"),
    (1, 100, 3, 16, 8, torch.float32, "simt"),     # the exact recurrence (l < 256)
])
def test_ssd_scan_backward_is_the_plain_vjp(cuda, b, l, h, dh, ds, dtype, route):
    """The Mamba layer's inputs: x a slice of the conv output, b times dt,
    c broadcast over the heads (stride 0)."""
    rng = np.random.default_rng(l + ds)
    xbc = _randn(rng, (b, l, h * dh + 2 * ds), cuda, dtype).requires_grad_(True)
    dt = torch.as_tensor(rng.uniform(0.01, 0.5, (b, l, h)).astype(np.float32),
                         device=cuda).requires_grad_(True)

    def inputs(xbc, dt):
        x = xbc[..., :h * dh].reshape(b, l, h, dh)
        bb = (xbc[..., h * dh:h * dh + ds][:, :, None, :] * dt[..., None]).to(dtype)
        c = xbc[..., h * dh + ds:][:, :, None, :].expand(b, l, h, ds)
        return x, -0.7 * dt, bb, c

    assert ssd_scan.route(dtype, dh, ds) == route
    ops.reset_launch_counts()
    got = ops.ssd_scan(*inputs(xbc, dt))
    assert ssd_scan.route_launches == {**{"tc": 0, "simt": 0}, route: 1}
    want = ops._plain_ssd(*inputs(xbc, dt))
    rtol, atol = SSD_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        _bf16_one_ulp(got.detach(), want.detach())
    g = _randn(rng, tuple(got.shape), cuda, dtype)
    got_g = _grads(got, (xbc, dt), g)
    assert ssd_scan.launches["ssd_scan"] == 1
    for a, w in zip(got_g, _grads(want, (xbc, dt), g)):
        assert torch.equal(a, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_gather_backward_is_the_plain_vjp(cuda, dtype):
    """Top-2 routing's slots (a token in two slots), empty slots and ids
    beyond t."""
    rng = np.random.default_rng(11)
    t, d, s = 300, 256, 700
    x = _randn(rng, (t, d), cuda, dtype).requires_grad_(True)
    idx = torch.as_tensor(np.concatenate([rng.permutation(np.repeat(np.arange(t), 2)),
                                          np.full(90, -1), np.arange(t, t + 10)]),
                          dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    buf, scales = ops.dispatch_gather(x, idx, quant=False)
    assert buf.requires_grad and not scales.requires_grad
    want = ref.dispatch_gather(x, idx, quant=False)[0]
    assert torch.equal(buf, want)
    g = _randn(rng, (s, d), cuda, dtype)
    got_g = _grads(buf, (x,), g)
    assert ops.launch_counts()["dispatch_gather"] == 1
    assert torch.equal(got_g[0], _grads(want, (x,), g)[0])


# One train step of a tiny configuration: each of its kernels launched once
# per layer in the forward (none in the backward: the plain VJPs).
TRAIN_KERNELS = {
    "qwen3-8b": {"flash_attention": 2},
    "mamba2-1.3b": {"ssd_scan": 2},
    "llama4-scout-17b-a16e": {"flash_attention": 2, "dispatch_gather": 2},
    "minicpm3-4b": {"flash_attention": 2},
    "whisper-small": {"flash_attention": 2 + 2 + 2},
    "jamba-1.5-large-398b": {"flash_attention": 2, "ssd_scan": 14, "dispatch_gather": 2},
}


@pytest.mark.parametrize("arch", list(TRAIN_KERNELS))
def test_train_step_card_equals_cpu(cuda, arch):
    """``build_train_step`` on the card (the kernels forward, the plain VJPs
    backward) against the CPU (plain versions): the kernels of the plan,
    loss and gnorm within 1e-4, every parameter after the step within 1e-4."""
    from repro_torch.data import pipeline
    from repro_torch.parallel import api as par
    from repro_torch.train import step as train_step

    cfg = configs.get_config(arch).tiny()
    tcfg = train_step.TrainConfig(opt=train_step.opt_mod.OptConfig(lr=1e-2, warmup=0))
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2,
                               frontend=cfg.frontend, frontend_seq=cfg.frontend_seq,
                               prefix_len=cfg.prefix_len, d_model=cfg.d_model)
    batch = pipeline.batch_at(dcfg, 0)
    step_fn = train_step.build_train_step(cfg, tcfg, par.ParallelCtx())
    out = {}
    for device in ("cpu", "cuda"):
        state = train_step.make_train_state(cfg, tcfg, 0, device="cpu")
        state = train_step.state_for(state.params.to(device), tcfg)
        ops.reset_launch_counts()
        state, metrics = step_fn(state, {k: torch.as_tensor(v, device=device)
                                         for k, v in batch.items()})
        out[device] = (state, metrics, {k: n for k, n in ops.launch_counts().items() if n})
    (cpu, m_cpu, n_cpu), (card, m_card, n_card) = out["cpu"], out["cuda"]
    assert n_cpu == {} and n_card == TRAIN_KERNELS[arch]
    for key in ("loss", "gnorm"):
        torch.testing.assert_close(m_card[key].cpu(), m_cpu[key], rtol=1e-4, atol=1e-4)
    for (name, a), (_, b) in zip(card.params.named_parameters(), cpu.params.named_parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-4, atol=1e-4,
                                   msg=name)


# -- the DDC facade (repro_torch.ddc) and its snapshot query tier -----------------

def _facade(backend, k, schedule, device, n=2048, layout="rings"):
    spec = spatial.PHASE2_LAYOUTS[layout]
    cfg = ddc_api.DDCConfig(eps=spec["eps"], min_pts=spec["min_pts"], grid=spec["grid"],
                            max_verts=spec["max_verts"], max_clusters=spec["max_clusters"],
                            backend=backend, shards=k, schedule=schedule)
    pts = spec["make"](n)
    return ddc_api.DDC(cfg, device=device).fit(pts), pts


def _probes(pts):
    rng = np.random.default_rng(1)
    return np.concatenate([pts[::5], pts[::3] + rng.uniform(-0.01, 0.01, (len(pts[::3]), 2)),
                           rng.uniform(1.2, 1.5, (16, 2))]).astype(np.float32)


@pytest.mark.parametrize("schedule", ["sync", "async", "tree"])
@pytest.mark.parametrize("k", [2, 8])
def test_facade_jit_card_equals_cpu(cuda, k, schedule):
    """The jit backend on the card (default device) launches the path's
    kernels inside the fit and equals the CPU run: labels, query answers
    and comm counts."""
    ops.reset_launch_counts()
    on_card, pts = _facade("jit", k, schedule, "cuda")
    labels = on_card.labels_
    counts = ops.launch_counts()
    assert counts["contour_min_d2"] > 0
    assert counts["neighbor_count"] + counts["neighbor_count_sparse"] == k
    on_cpu, _ = _facade("jit", k, schedule, "cpu")
    np.testing.assert_array_equal(labels, on_cpu.labels_)
    q = _probes(pts)
    np.testing.assert_array_equal(np.asarray(on_card.query(q)), np.asarray(on_cpu.query(q)))
    assert on_card.comm_stats() == on_cpu.comm_stats()
    snap = on_card.backend.snapshot()
    assert snap.pts.device.type == snap.mask.device.type == snap.glabels.device.type == "cuda"


def test_facade_default_device_is_the_card(cuda):
    spec = spatial.PHASE2_LAYOUTS["rings"]
    model = ddc_api.DDC(ddc_api.DDCConfig(eps=spec["eps"], backend="host", shards=2))
    assert model.device.type == "cuda" and model.backend.device.type == "cuda"


@pytest.mark.parametrize("k", [2, 4])
def test_facade_host_card_equals_cpu(cuda, k):
    on_card, pts = _facade("host", k, "sync", "cuda", layout="linked_ovals")
    on_cpu, _ = _facade("host", k, "sync", "cpu", layout="linked_ovals")
    np.testing.assert_array_equal(on_card.labels_, on_cpu.labels_)
    q = _probes(pts)
    np.testing.assert_array_equal(np.asarray(on_card.query(q)), np.asarray(on_cpu.query(q)))
    jit, _ = _facade("jit", k, "sync", "cuda", layout="linked_ovals")
    assert ddc.same_clustering(on_card.labels_, jit.labels_)


def test_facade_save_load_on_card(cuda, tmp_path):
    model, pts = _facade("jit", 4, "tree", "cuda")
    q = _probes(pts)
    want = np.asarray(model.query(q))
    model.save(str(tmp_path / "ckpt"))
    for device in ("cuda", "cpu"):
        restored = ddc_api.DDC.load(str(tmp_path / "ckpt"), device=device)
        np.testing.assert_array_equal(restored.labels_, model.labels_)
        np.testing.assert_array_equal(np.asarray(restored.query(q)), want)
        assert restored.backend.refits == 0


@pytest.mark.parametrize("n,cap,k", [(32, 64, 1), (256, 4096, 8), (17, 300, 3)])
def test_snapshot_query_card_equals_cpu(cuda, n, cap, k):
    """The snapshot query (plain torch, fma(dy, dy, dx·dx)) gives the same
    labels on the card as on the CPU: ties, masked and noise rows."""
    rng = np.random.default_rng(n + cap)
    q = (0.5 + rng.integers(0, 1 << 22, (n, 2)) * 2.0 ** -24).astype(np.float32)
    d = (rng.integers(1 << 15, 1 << 17, (n, 2)) * 2.0 ** -24).astype(np.float32)
    pts = rng.uniform(0, 1, (k, cap, 2)).astype(np.float32)
    flat = pts.reshape(-1, 2)
    flat[0:2 * n:2] = q + d
    flat[1:2 * n:2] = q + d[:, ::-1]
    mask = rng.random((k, cap)) > 0.1
    glab = rng.integers(-1, 7, (k, cap)).astype(np.int32)
    args = [torch.tensor(a) for a in (q, pts, mask, glab)]
    want = query_tier._snapshot_query(*args, 0.05)
    got = query_tier._snapshot_query(*(a.to(cuda) for a in args), 0.05)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


def _stream_run(device, layout, k):
    """One call sequence through the stream engine on ``device``: fit-style
    round-robin ingest, a refresh after every round, an eviction, a TTL
    expiry, a forced full re-merge and queries.  Returns what it saw."""
    from repro_torch.serve import cluster_service as cs

    spec = spatial.PHASE2_LAYOUTS[layout]
    pts = spec["make"](2048)
    cfg = ddc.DDCConfig(**{f: spec[f] for f in ("eps", "min_pts", "grid", "max_verts",
                                                "max_clusters")})
    scfg = cs.StreamConfig(shards=k, capacity=spatial.shard_capacity(2048, k), max_batch=128,
                           ddc=cfg)
    svc = cs.ClusterService(scfg, meter=ddc.CommMeter(), device=device)
    seen = []
    for i, (shard, chunk) in enumerate(spatial.stream_batches(pts, k, 128)):
        svc.ingest(shard, chunk, t=float(i))
        if i % k == k - 1:
            svc.refresh()
            seen.append((svc._glabels.cpu().numpy(), svc.pair_d2.cpu().numpy()))
    svc.evict_oldest(1, 50)
    svc.refresh()
    svc.evict_older_than(2, 3.0)
    seen.append(svc.query(pts[::3]).labels)
    svc.refresh(mode="full", force=True)
    seen.append((svc._glabels.cpu().numpy(), svc.pair_d2.cpu().numpy()))
    arrays, manifest = svc.state_dict()
    back = cs.ClusterService.from_state(scfg, arrays, manifest, device=device)
    seen.append(back.query(pts[::5]).labels)
    return seen, svc.meter.snapshot(), arrays, manifest


@pytest.mark.parametrize("layout", ["rings", "linked_ovals"])
def test_stream_engine_card_equals_cpu(cuda, layout):
    """The stream engine on the card gives the CPU's labels, pair-d2,
    answers, meter counts and state_dict arrays, bit for bit, at K 4."""
    ops.reset_launch_counts()
    card = _stream_run(cuda, layout, 4)
    counts = ops.launch_counts()
    cpu = _stream_run("cpu", layout, 4)
    assert counts["contour_min_d2"] >= 2 and counts["cross_min_d2"] >= 1
    for a, b in zip(card[0], cpu[0]):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)
    assert card[1] == cpu[1]
    assert sorted(card[2]) == sorted(cpu[2]) and card[3] == cpu[3]
    for key in card[2]:
        assert card[2][key].dtype == cpu[2][key].dtype, key
        np.testing.assert_array_equal(card[2][key], cpu[2][key], err_msg=key)


def test_stream_engine_fault_recovery_on_card(cuda):
    """A lane killed on the card: quarantine, writes journaled during the
    outage, journal recovery, then the fault-free engine's labels, pair-d2
    and answers, bit for bit."""
    from repro_torch.serve import cluster_service as cs
    from repro_torch.serve import faults

    spec = spatial.PHASE2_LAYOUTS["rings"]
    pts = spec["make"](2048)
    cfg = ddc.DDCConfig(**{f: spec[f] for f in ("eps", "min_pts", "grid", "max_verts",
                                                "max_clusters")})
    scfg = cs.StreamConfig(shards=4, capacity=512, max_batch=128, ddc=cfg)
    plan = faults.FaultPlan(events=(faults.FaultEvent("kill", shard=3),))
    hit = cs.ClusterService(scfg, faults=plan, device=cuda)
    clean = cs.ClusterService(scfg, device=cuda)
    for svc in (hit, clean):
        for shard, chunk in spatial.stream_batches(pts[:1536], 4, 128):
            svc.ingest(shard, chunk)
        svc.refresh()
    assert 3 in hit.quarantined and not hit._mask[3].any()
    for svc in (hit, clean):
        svc.ingest(3, pts[1536:])
        svc.refresh()
    assert hit.recover(3)
    hit.refresh()
    assert not hit.quarantined
    np.testing.assert_array_equal(hit.pair_d2.cpu().numpy(), clean.pair_d2.cpu().numpy())
    np.testing.assert_array_equal(hit._glabels.cpu().numpy(), clean._glabels.cpu().numpy())
    np.testing.assert_array_equal(hit.query(pts[::3]).labels, clean.query(pts[::3]).labels)


def _tree_run(device):
    """One call sequence through the stream engine's tree of aggregators
    (degree 2) on ``device``, at "rings", 4 shards: refreshes every second
    chunk, a quarantined leaf and its recovery, a forced full re-merge and
    a restore.  Returns what two devices must agree on."""
    from repro_torch.serve import cluster_service as cs

    spec = spatial.PHASE2_LAYOUTS["rings"]
    pts = spec["make"](2048)
    cfg = ddc.DDCConfig(**{f: spec[f] for f in ("eps", "min_pts", "grid", "max_verts",
                                                "max_clusters")})
    scfg = cs.StreamConfig(shards=4, capacity=512, max_batch=128, agg_degree=2, ddc=cfg)
    svc = cs.ClusterService(scfg, meter=ddc.CommMeter(), device=device)
    seen = []

    def record():
        g = svc.global_set
        seen.append([svc._glabels.cpu().numpy(), svc._maps.cpu().numpy()]
                    + [t.cpu().numpy() for t in g] + [dict(svc.hierarchy.last_stats)])

    for i, (shard, chunk) in enumerate(spatial.stream_batches(pts, 4, 128)):
        svc.ingest(shard, chunk)
        if i % 2:
            svc.refresh()
            record()
    svc._quarantine(3, "test fence")
    svc.refresh(force=True)
    record()
    assert svc.recover(3)
    svc.refresh()
    record()
    svc.refresh(mode="full", force=True)
    record()
    assert svc.pair_d2 is None and svc.hierarchy.cache_exact()
    arrays, manifest = svc.state_dict()
    back = cs.ClusterService.from_state(scfg, arrays, manifest, device=device)
    assert back.hierarchy.cache_exact()
    seen.append([back._glabels.cpu().numpy(), back.query(pts[::5]).labels])
    return seen, svc.meter.snapshot(), svc.hierarchy.cache_arrays(), arrays, manifest


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a == b
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_tree_card_equals_cpu(cuda):
    """The tree of aggregators on the card gives the CPU's labels, maps,
    global set, per-refresh stats, node caches, meter counts and
    state_dict, bit for bit; its node folds run B5 in both forms."""
    ops.reset_launch_counts()
    card = _tree_run(cuda)
    counts = ops.launch_counts()
    cpu = _tree_run("cpu")
    assert counts["contour_min_d2"] >= 1 and counts["cross_min_d2"] >= 1
    for a, b in zip(card[0], cpu[0], strict=True):
        for x, y in zip(a, b, strict=True):
            _assert_same(x, y)
    assert card[1] == cpu[1]
    for x, y in zip(card[2], cpu[2], strict=True):
        _assert_same(x, y)
    assert sorted(card[3]) == sorted(cpu[3]) and card[4] == cpu[4]
    for key in card[3]:
        _assert_same(card[3][key], cpu[3][key])


def _tracking_run(device, agg):
    """drifting_blobs through the facade's stream backend with tracking,
    at 4 shards (``agg`` the tree's degree, or None), on ``device``."""
    from repro_torch.serve import tracking

    spec = spatial.TRAJECTORY_LAYOUTS["drifting_blobs"]
    cap = spatial.trajectory_capacity(spec["n_per_step"], spec["window"], 4)
    cfg = ddc_api.DDCConfig(
        eps=spec["eps"], min_pts=spec["min_pts"], grid=spec["grid"],
        max_clusters=spec["max_clusters"], max_verts=spec["max_verts"], backend="stream",
        shards=4, capacity=cap, max_batch=min(256, cap), agg_degree=agg, track=True).validate()
    traj = spec["make"](steps=spec["steps"], n_per_step=spec["n_per_step"])
    model = ddc_api.DDC(cfg, device=device)
    snap = tracking.play(model, traj.frames, window=spec["window"])
    return snap, model.service.tracker.state_dict()


@pytest.mark.parametrize("agg", [None, 2])
def test_tracking_card_equals_cpu(cuda, agg):
    """The tracker on the card (its match distance on B5's rectangular
    form) folds drifting_blobs at 4 shards to the CPU's state bit for bit:
    every array, the manifest and the published TrackSnapshot."""
    import dataclasses

    ops.reset_launch_counts()
    card_snap, (card_arrays, card_manifest) = _tracking_run(cuda, agg)
    counts = ops.launch_counts()
    cpu_snap, (cpu_arrays, cpu_manifest) = _tracking_run("cpu", agg)
    steps = spatial.TRAJECTORY_LAYOUTS["drifting_blobs"]["steps"]
    assert counts["cross_min_d2"] >= steps - 1
    assert card_manifest == cpu_manifest
    assert sorted(card_arrays) == sorted(cpu_arrays)
    for key in card_arrays:
        _assert_same(card_arrays[key], cpu_arrays[key])
    assert dataclasses.asdict(card_snap) == dataclasses.asdict(cpu_snap)
    assert card_snap.births == 3 and card_snap.deaths == 0


def _dist_run(device, engine):
    """One call sequence through ``engine`` ("dist" or "stream") on
    ``device``: 4 lanes of 4,096 points (make_d2, Morton-sorted, block-sparse
    DBSCAN in tiles of 128), a round-robin fit, 4 one-shard rounds of
    1,024 points, a TTL expiry (every lane dirty), a forced full re-merge,
    queries and a restore; the state after every refresh."""
    from repro_torch.serve import cluster_service as cs
    from repro_torch.serve import dist_service as ds

    k, cap = 4, 4096
    pts = spatial.morton_sorted(spatial.make_d2(k * cap, seed=1))
    new = spatial.morton_sorted(spatial.make_d2(4 * 1024, seed=2))
    cfg = ddc.DDCConfig(eps=0.032, min_pts=4, block_sparse="always", block_tile=128)
    scfg = cs.StreamConfig(shards=k, capacity=cap, max_batch=256, ddc=cfg)
    cls = ds.DistClusterService if engine == "dist" else cs.ClusterService
    svc = cls(scfg, meter=ddc.CommMeter(), device=device)
    seen = []

    def record():
        glab = svc.stacked("_glabels") if engine == "dist" else svc._glabels
        dense = svc.stacked("_dense") if engine == "dist" else svc._dense
        seen.append([ddc.host_copy(t) for t in (glab, dense, svc._maps, svc.pair_d2)])

    for shard, chunk in spatial.stream_batches(pts, k, 256):
        svc.ingest(shard, chunk, t=0.0)
    svc.refresh()
    record()
    for r in range(4):
        svc.ingest(r % k, new[r * 1024:(r + 1) * 1024], t=float(r + 1))
        svc.refresh()
        record()
        seen.append([svc.query(pts[r::37]).labels])
    svc.evict_older_than(0, 1.0)
    for s in range(k):
        svc.evict_oldest(s, 64)
    svc.refresh()
    record()
    svc.refresh(mode="full", force=True)
    record()
    arrays, manifest = svc.state_dict()
    back = cls.from_state(scfg, arrays, manifest, device=device)
    seen.append([back.query(pts[::5]).labels])
    return seen, svc.meter.snapshot(), arrays, manifest, svc


def test_dist_engine_card_equals_stream_and_cpu(cuda):
    """The dist engine on the card, its lanes on 4 distinct streams, gives
    the stream engine's labels, dense labels, maps, pair-d2 and answers
    after every refresh, and the CPU's, with the same meter counts and
    state_dict, bit for bit."""
    ops.reset_launch_counts()
    dist = _dist_run(cuda, "dist")
    counts = ops.launch_counts()
    lanes = dist[4].lanes
    streams = {lane.stream.cuda_stream for lane in lanes}
    assert len(streams) == 4 and torch.cuda.current_stream().cuda_stream not in streams
    assert counts["neighbor_count_sparse"] >= 9 and counts["cross_min_d2"] >= 4
    assert counts["contour_min_d2"] >= 2
    stream = _dist_run(cuda, "stream")
    cpu = _dist_run("cpu", "dist")
    for other in (stream, cpu):
        for a, b in zip(dist[0], other[0], strict=True):
            for x, y in zip(a, b, strict=True):
                _assert_same(x, y)
        assert dist[1] == other[1]
        assert sorted(dist[2]) == sorted(other[2]) and dist[3] == other[3]
        for key in dist[2]:
            _assert_same(dist[2][key], other[2][key])


def test_dist_engine_fault_recovery_on_card(cuda):
    """A dist lane killed on the card: quarantine, journal recovery, then
    the fault-free dist engine's labels, pair-d2 and answers."""
    from repro_torch.serve import cluster_service as cs
    from repro_torch.serve import dist_service as ds
    from repro_torch.serve import faults

    spec = spatial.PHASE2_LAYOUTS["rings"]
    pts = spec["make"](2048)
    cfg = ddc.DDCConfig(**{f: spec[f] for f in ("eps", "min_pts", "grid", "max_verts",
                                                "max_clusters")})
    scfg = cs.StreamConfig(shards=4, capacity=512, max_batch=128, ddc=cfg)
    plan = faults.FaultPlan(events=(faults.FaultEvent("kill", shard=2),))
    hit = ds.DistClusterService(scfg, faults=plan, device=cuda)
    clean = ds.DistClusterService(scfg, device=cuda)
    for svc in (hit, clean):
        for shard, chunk in spatial.stream_batches(pts[:1536], 4, 128):
            svc.ingest(shard, chunk)
        svc.refresh()
    assert 2 in hit.quarantined and not hit._mask[2].any()
    for svc in (hit, clean):
        svc.ingest(2, pts[1536:])
        svc.refresh()
    assert hit.recover(2)
    hit.refresh()
    assert not hit.quarantined
    np.testing.assert_array_equal(hit.pair_d2.cpu().numpy(), clean.pair_d2.cpu().numpy())
    np.testing.assert_array_equal(hit.stacked("_glabels").cpu().numpy(),
                                  clean.stacked("_glabels").cpu().numpy())
    np.testing.assert_array_equal(hit.query(pts[::3]).labels, clean.query(pts[::3]).labels)


def test_ranks_on_card_equal_one_process(cuda):
    """ddc_shard on 4 rank processes sharing the card (gloo) under sync,
    async and tree: labels, maps, every rank's global ClusterSet, the meter
    and the ranks' gloo bytes equal the one-process run on the card; each
    rank's B5 launches equal its folds, and every rank launches a count
    and a sweep kernel (B3 and B4, or B1 and B2 where a lane's tile pairs
    fall back to the dense path)."""
    from repro_torch.launch import ranks

    spec = spatial.PHASE2_LAYOUTS["rings"]
    pts = spec["make"](8192)
    base = ddc.DDCConfig(**{f: spec[f] for f in ("eps", "min_pts", "grid", "max_verts",
                                                 "max_clusters")}, block_tile=256)
    cfgs = [dataclasses.replace(base, schedule=s) for s in ("sync", "async", "tree")]
    mask = np.ones(len(pts), bool)
    results = ranks.run_ddc_cases([dict(points=pts, mask=mask, cfg=c, k=4) for c in cfgs],
                                  4, device="cuda", timeout=300)
    for cfg, res in zip(cfgs, results):
        meter = ddc.CommMeter()
        glabels, gcs, maps = ddc.make_ddc_fn(cfg, 4, device=cuda, meter=meter)(pts, mask)
        np.testing.assert_array_equal(res.glabels, glabels.cpu().numpy())
        np.testing.assert_array_equal(res.maps, maps.cpu().numpy())
        for rec in res.ranks:
            for got, want in zip(rec["gcs"], gcs):
                np.testing.assert_array_equal(got, want.cpu().numpy())
            got = rec["launches"]
            assert got.get("neighbor_count_sparse", 0) + got.get("neighbor_count", 0) >= 1
            assert got.get("min_label_sweep_sparse", 0) + got.get("min_label_sweep", 0) >= 1
            assert got.get("contour_min_d2", 0) == rec["merge_calls"]
        assert res.meter == meter.snapshot() and res.sent_bytes == meter.bytes_total


def test_curation_on_card_equals_cpu(cuda):
    from repro_torch.data import curation, pipeline
    from repro_torch.launch import mesh

    dcfg = pipeline.DataConfig(vocab=512, seq_len=32, global_batch=4, n_latent_clusters=8)
    emb, _ = pipeline.doc_embeddings(dcfg, 4000)
    got = curation.curate(emb, mesh=mesh.make_lane_mesh(8, cuda))
    want = curation.curate(emb, mesh=mesh.make_lane_mesh(8, "cpu"))
    for f in ("labels", "cluster_sizes", "sample_weights"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.exchanged_fraction == want.exchanged_fraction and got.n_clusters == 8


@pytest.mark.parametrize("sched", ["sync", "tree", "async"])
def test_dryrun_cell_on_card_equals_cpu(cuda, sched):
    from repro_torch.launch import dryrun_ddc

    pts = spatial.make_d2(2048, seed=1)
    got = dryrun_ddc.run_cell(16, sched, pts, device=cuda)
    want = dryrun_ddc.run_cell(16, sched, pts, device="cpu")
    keys = ("cell", "wire_budget_bytes", "bytes_total", "collectives", "merge_steps",
            "merge_slots", "merge_calls", "n_clusters", "overflow")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["peak_memory_bytes"] > 0


def test_hull_and_min_distance_on_card_equal_cpu(cuda):
    from repro_torch.core import geometry

    rng = np.random.default_rng(3)
    for n in (4, 24, 300):
        t = rng.uniform(0, 1, n)
        pts = np.concatenate([rng.uniform(0, 1, (n, 2)),
                              np.stack([t, 0.3 + 0.7 * t], -1) + rng.normal(0, 1e-7, (n, 2))])
        pts = torch.as_tensor(pts.astype(np.float32))
        mask = torch.as_tensor(rng.random(2 * n) > 0.1)
        got = geometry.convex_hull_torch(pts.to(cuda), mask.to(cuda), 70)
        want = geometry.convex_hull_torch(pts, mask, 70)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        cnt = torch.tensor(n, dtype=torch.int32)
        d_got = geometry.min_cross_distance_sq(pts[:n].to(cuda), cnt.to(cuda), pts[n:].to(cuda),
                                               cnt.to(cuda))
        assert torch.equal(d_got.cpu(), geometry.min_cross_distance_sq(pts[:n], cnt, pts[n:], cnt))
