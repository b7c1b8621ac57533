"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc (the kernels build at first
use); elsewhere they skip.  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

This file imports no JAX, so it runs where only PyTorch is installed.
Kernels and plain versions compute the same float32 expressions without
FMA contraction, so every comparison is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ddc  # noqa: E402
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
    assert all(v > 0 for v in ops.launch_counts().values())
    on_cpu = ddc.make_ddc_fn(cfg, 4, device="cpu")(pts, mask)
    for a, b in zip((on_card[0], *on_card[1], on_card[2]), (on_cpu[0], *on_cpu[1], on_cpu[2])):
        assert torch.equal(a.cpu(), b)
