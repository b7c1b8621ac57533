"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc (the kernels build at first
use); elsewhere they skip.  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

This file imports no JAX, so it runs where only PyTorch is installed.
Kernels and plain versions compute the same float32 expressions, each
FMA where the other has one and no other contraction, so every
comparison is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dbscan, ddc  # noqa: E402
from repro_torch.data import spatial  # noqa: E402
from repro_torch.kernels import contour_dist, ops, pairwise_dist, ref  # noqa: E402

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
            row_ptr=pairs.row_ptr.long()), bt=64)
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
