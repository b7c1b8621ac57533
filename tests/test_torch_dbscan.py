"""The port's dense DBSCAN against the reference package's
(``dbscan(..., block_sparse="never")``) on the tests/test_dbscan.py
inputs: labels, core, n_clusters and n_sweeps must be equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import dbscan as jdb  # noqa: E402
from repro.data import spatial  # noqa: E402
from repro_torch.core import dbscan as tdb  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _both(pts, mask, eps, min_pts, **kw):
    j = jdb.dbscan(jnp.asarray(pts), jnp.asarray(mask), eps, min_pts,
                   block_sparse="never", **kw)
    t = tdb.dbscan(torch.from_numpy(pts), torch.from_numpy(mask), eps, min_pts,
                   block_sparse="never", **kw)
    return j, t


def assert_same_result(j, t):
    assert t.labels.dtype == torch.int32 and t.core.dtype == torch.bool
    assert t.n_clusters.dtype == torch.int32 and t.n_sweeps.dtype == torch.int32
    for field in tdb.DBSCANResult._fields:
        np.testing.assert_array_equal(getattr(t, field).numpy(),
                                      np.asarray(getattr(j, field)), err_msg=field)


def _uniform(seed, n=120):
    return np.random.default_rng(seed).uniform(0, 1, (n, 2)).astype(np.float32)


CASES = {
    "blobs0": lambda: (spatial.make_blobs(200, 3, seed=0)[0], 0.05, 5),
    "blobs1": lambda: (spatial.make_blobs(200, 5, seed=1)[0], 0.05, 5),
    "blobs2": lambda: (spatial.make_blobs(200, 8, seed=2)[0], 0.05, 5),
    "uniform_a": lambda: (_uniform(3), 0.09, 3),
    "uniform_b": lambda: (_uniform(77), 0.15, 8),
    "uniform_c": lambda: (_uniform(512), 0.02, 2),
    "noise": lambda: (np.concatenate([spatial.make_blobs(150, 2, seed=5)[0],
                                      np.array([[0.01, 0.99]], np.float32)]), 0.04, 5),
    "min_index": lambda: (spatial.make_blobs(80, 2, seed=9)[0], 0.06, 4),
    "worm": lambda: (spatial.make_worm(600, waves=1, amp=0.1), 0.015, 5),
}


@pytest.mark.parametrize("name", list(CASES))
def test_dense_dbscan_equals_reference(name):
    pts, eps, min_pts = CASES[name]()
    j, t = _both(pts, np.ones(len(pts), bool), eps, min_pts)
    assert_same_result(j, t)
    np.testing.assert_array_equal(t.labels.numpy(), tdb.dbscan_ref(pts, eps, min_pts))


def test_padding_mask():
    pts, _ = spatial.make_blobs(100, 3, seed=4)
    padded = np.concatenate([pts, np.zeros((28, 2), np.float32)])
    mask = np.array([True] * 100 + [False] * 28)
    j, t = _both(padded, mask, 0.05, 5)
    assert_same_result(j, t)
    assert (t.labels.numpy()[100:] == tdb.NOISE).all()


@pytest.mark.parametrize("kw", [dict(pointer_doubling=False), dict(max_iters=1),
                                dict(max_iters=2, pointer_doubling=False)])
def test_propagation_options(kw):
    pts = spatial.make_worm(400, waves=1, amp=0.1)
    j, t = _both(pts, np.ones(len(pts), bool), 0.015, 5, **kw)
    assert_same_result(j, t)


def test_offset_coordinates_are_centred():
    pts = spatial.make_blobs(200, 4, seed=6)[0] + np.float32(100.0)
    j, t = _both(pts, np.ones(len(pts), bool), 0.05, 5)
    assert_same_result(j, t)


@pytest.mark.parametrize("seed", range(4))
def test_dbscan_ref_copy(seed):
    pts = _uniform(seed, 90)
    for eps, min_pts in ((0.08, 3), (0.12, 6)):
        np.testing.assert_array_equal(tdb.dbscan_ref(pts, eps, min_pts),
                                      jdb.dbscan_ref(pts, eps, min_pts))


def test_relabel_dense():
    labels = np.array([0, 0, -1, 3, 3, 3, 0], np.int32)
    for cap in (8, 1, 2):
        got = tdb.relabel_dense(torch.from_numpy(labels), cap)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jdb.relabel_dense(jnp.asarray(labels), cap)))
    res = jdb.dbscan(jnp.asarray(spatial.make_blobs(300, 9, seed=2)[0]),
                     jnp.ones(300, bool), 0.05, 5, block_sparse="never")
    for cap in (3, 16):
        np.testing.assert_array_equal(
            tdb.relabel_dense(torch.from_numpy(np.array(res.labels)), cap).numpy(),
            np.asarray(jdb.relabel_dense(res.labels, cap)))


def test_block_sparse_options():
    pts = torch.from_numpy(spatial.make_blobs(1200, 4, seed=1)[0])
    mask = torch.ones(len(pts), dtype=torch.bool)
    # "auto" off the GPU is the dense path, as in the reference off-TPU.
    auto = tdb.dbscan(pts, mask, 0.05, 5, block_sparse="auto")
    never = tdb.dbscan(pts, mask, 0.05, 5, block_sparse="never")
    for a, b in zip(auto, never):
        assert torch.equal(a, b)
    # "always" takes the block-sparse path on any device, bit-identical to
    # the dense path but for the sweep count.
    always = tdb.dbscan(pts, mask, 0.05, 5, block_sparse="always")
    for a, b in zip(always[:3], never[:3]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tdb.dbscan(pts, mask, 0.05, 5, block_sparse="sometimes")
