"""The port's plain versions of the LM kernels (attention and the Mamba-2
SSD scan) against the reference package's jnp oracles and its Pallas
kernels in interpret mode, on tests/test_kernels.py's shapes, and the
port's routing of those ops on CPU tensors.  Runs on the CPU; the CUDA
kernels are held against these plain versions on the card by
tests/test_torch_gpu.py.

Tolerances are tests/test_kernels.py's, for the same reason (float32 sums
in another order): attention 3e-4 (the chunked form 1e-4, as there), SSD
5e-4, and 0.05 for bf16 outputs, which may differ by one bf16 rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ssd_scan as jssd  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402

F32 = dict(rtol=3e-4, atol=3e-4)
BF16 = dict(rtol=0.05, atol=0.05)
SSD = dict(rtol=5e-4, atol=5e-4)


def _randn(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


# -- attention -------------------------------------------------------------------

# tests/test_kernels.py::TestFlashAttention: (b, h, hkv, sq, skv, d, bq, bk)
FLASH_SWEEP = [
    (1, 4, 4, 128, 128, 32, 64, 64),     # MHA square
    (2, 8, 2, 128, 256, 64, 64, 128),    # GQA, decode-style kv > q
    (1, 4, 1, 256, 256, 32, 128, 64),    # MQA
    (2, 2, 2, 64, 64, 128, 64, 64),      # large head dim
]


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,bq,bk", FLASH_SWEEP)
def test_flash_attention_causal_sweep(b, h, hkv, sq, skv, d, bq, bk):
    rng = np.random.default_rng(sq + skv + d)
    q, k, v = _randn(rng, (b, h, sq, d)), _randn(rng, (b, hkv, skv, d)), _randn(rng, (b, hkv, skv, d))
    got = _np(tref.flash_attention(_t(q), _t(k), _t(v), causal=True))
    np.testing.assert_allclose(got, _np(jref.flash_attention(_j(q), _j(k), _j(v))), **F32)
    pallas = jfa.flash_attention(_j(q), _j(k), _j(v), causal=True, bq=bq, bk=bk, interpret=True)
    np.testing.assert_allclose(got, _np(pallas), **F32)


@pytest.mark.parametrize("causal,window", [(False, None), (True, 32), (True, 100)])
def test_flash_attention_non_causal_and_windowed(causal, window):
    rng = np.random.default_rng(window or 0)
    s = 192 if window else 128
    q, k, v = (_randn(rng, (1, 2, s, 32)) for _ in range(3))
    got = _np(tref.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window))
    want = jref.flash_attention(_j(q), _j(k), _j(v), causal=causal, window=window)
    np.testing.assert_allclose(got, _np(want), **F32)
    pallas = jfa.flash_attention(_j(q), _j(k), _j(v), causal=causal, window=window,
                                 bq=64, bk=64, interpret=True)
    np.testing.assert_allclose(got, _np(pallas), **F32)


def test_flash_attention_bf16():
    rng = np.random.default_rng(1)
    q, k, v = (_randn(rng, (1, 2, 128, 32)) for _ in range(3))
    got = tref.flash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                               _t(v, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = jref.flash_attention(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16))
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


def test_flash_attention_masks_with_minus_inf():
    """The exact version masks with −inf, as the reference: a row that
    sees no key (sq > skv, causal) is NaN in both."""
    rng = np.random.default_rng(2)
    q, k, v = _randn(rng, (1, 1, 6, 8)), _randn(rng, (1, 1, 4, 8)), _randn(rng, (1, 1, 4, 8))
    got = _np(tref.flash_attention(_t(q), _t(k), _t(v)))
    want = _np(jref.flash_attention(_j(q), _j(k), _j(v)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0, 0, :2]).all() and np.isfinite(got[0, 0, 2:]).all()
    np.testing.assert_allclose(got[0, 0, 2:], want[0, 0, 2:], **F32)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 100)])
def test_flash_attention_chunked(causal, window):
    """tests/test_kernels.py::test_chunked_ref_matches_exact's shapes: ragged
    q and kv blocks, GQA, right-aligned positions; 1e-4 as there."""
    rng = np.random.default_rng(3)
    q, k, v = _randn(rng, (2, 4, 300, 32)), _randn(rng, (2, 2, 520, 32)), _randn(rng, (2, 2, 520, 32))
    got = _np(tref.flash_attention_chunked(_t(q), _t(k), _t(v), causal=causal, window=window,
                                           bq=128, bk=128))
    want = jref.flash_attention_chunked(_j(q), _j(k), _j(v), causal=causal, window=window,
                                        bq=128, bk=128)
    np.testing.assert_allclose(got, _np(want), rtol=1e-4, atol=1e-4)
    exact = _np(tref.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window))
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-4)


# -- SSD scan --------------------------------------------------------------------

# tests/test_kernels.py::TestSSDScan: (b, l, h, dh, ds, chunk)
SSD_SWEEP = [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 3, 16, 8, 32),
    (1, 256, 1, 32, 16, 64),
    (2, 96, 4, 8, 4, 32),
]


def _ssd_inputs(rng, b, l, h, dh, ds, decay=0.1):
    return (_randn(rng, (b, l, h, dh)),
            (-np.abs(rng.normal(size=(b, l, h))) * decay).astype(np.float32),
            _randn(rng, (b, l, h, ds)), _randn(rng, (b, l, h, ds)))


@pytest.mark.parametrize("b,l,h,dh,ds,chunk", SSD_SWEEP)
def test_ssd_scan_sweep(b, l, h, dh, ds, chunk):
    rng = np.random.default_rng(l + ds)
    x, a, bb, c = _ssd_inputs(rng, b, l, h, dh, ds)
    got = _np(tref.ssd_scan(_t(x), _t(a), _t(bb), _t(c)))
    np.testing.assert_allclose(got, _np(jref.ssd_scan(_j(x), _j(a), _j(bb), _j(c))), **SSD)
    pallas = jssd.ssd_scan(_j(x), _j(a), _j(bb), _j(c), chunk=chunk, interpret=True)
    np.testing.assert_allclose(got, _np(pallas), **SSD)
    chunked = _np(tref.ssd_scan_chunked(_t(x), _t(a), _t(bb), _t(c), chunk=chunk))
    np.testing.assert_allclose(chunked, got, **SSD)
    np.testing.assert_allclose(
        chunked, _np(jref.ssd_scan_chunked(_j(x), _j(a), _j(bb), _j(c), chunk=chunk)), **SSD)


@pytest.mark.parametrize("chunk", [32, 128])
def test_ssd_scan_chunked_ragged(chunk):
    """tests/test_kernels.py::TestSSDScan::test_chunked_ref's l = 100: a
    ragged last chunk (and, at chunk 128, one chunk shorter than the
    chunk size)."""
    rng = np.random.default_rng(100)
    x, a, bb, c = _ssd_inputs(rng, 2, 100, 3, 16, 8)
    got = _np(tref.ssd_scan_chunked(_t(x), _t(a), _t(bb), _t(c), chunk=chunk))
    np.testing.assert_allclose(
        got, _np(jref.ssd_scan_chunked(_j(x), _j(a), _j(bb), _j(c), chunk=chunk)), **SSD)
    np.testing.assert_allclose(got, _np(tref.ssd_scan(_t(x), _t(a), _t(bb), _t(c))), **SSD)


def test_ssd_scan_bf16():
    rng = np.random.default_rng(4)
    x, a, bb, c = _ssd_inputs(rng, 1, 64, 2, 16, 8)
    got = tref.ssd_scan(_t(x, torch.bfloat16), _t(a), _t(bb, torch.bfloat16),
                        _t(c, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = jref.ssd_scan(_j(x, jnp.bfloat16), _j(a), _j(bb, jnp.bfloat16), _j(c, jnp.bfloat16))
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


def test_ssd_scan_decay_semantics():
    """tests/test_kernels.py's strong-decay case: the output is the
    instantaneous c·b x (no history)."""
    rng = np.random.default_rng(5)
    b, l, h, dh, ds = 1, 32, 1, 4, 4
    x, bb, c = _randn(rng, (b, l, h, dh)), _randn(rng, (b, l, h, ds)), _randn(rng, (b, l, h, ds))
    a = np.full((b, l, h), -50.0, np.float32)
    y = _np(tref.ssd_scan(_t(x), _t(a), _t(bb), _t(c)))
    want = np.einsum("blhs,blhs->blh", c, bb)[..., None] * x
    np.testing.assert_allclose(y, want, rtol=1e-3, atol=1e-3)


def test_ssd_scan_chunked_stays_finite_where_the_reference_overflows():
    """A chunk whose log-decays sum below −88 overflows exp(cum_i − cum_j)
    above the diagonal; the reference's ``decay * causal`` turns that
    inf·0 into NaN everywhere, while the Pallas kernel masks with
    ``where``.  The port masks as the kernel does: finite and equal to the
    sequential recurrence (and to the interpret-mode kernel)."""
    rng = np.random.default_rng(6)
    x, _, bb, c = _ssd_inputs(rng, 1, 256, 2, 8, 4)
    a = np.full((1, 256, 2), -0.7, np.float32)   # a Mamba-2 layer's decay at init
    jx, ja, jb, jc = _j(x), _j(a), _j(bb), _j(c)
    assert not np.isfinite(_np(jref.ssd_scan_chunked(jx, ja, jb, jc, chunk=128))).all()
    got = _np(tref.ssd_scan_chunked(_t(x), _t(a), _t(bb), _t(c), chunk=128))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _np(jref.ssd_scan(jx, ja, jb, jc)), **SSD)
    np.testing.assert_allclose(got, _np(jssd.ssd_scan(jx, ja, jb, jc, chunk=128,
                                                       interpret=True)), **SSD)


# -- routing on CPU tensors ----------------------------------------------------


def _spy(monkeypatch, module, names):
    calls = []
    for name in names:
        fn = getattr(module, name)

        def wrapped(*args, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("force", [None, "ref"])
@pytest.mark.parametrize("sq,skv,dv,want", [
    (64, 64, 16, "flash_attention"),              # small: exact
    (1024, 2048, 16, "flash_attention"),          # sq·skv = 2**21: still exact
    (1025, 2048, 16, "flash_attention_chunked"),  # above 2**21: chunked
    (1025, 2048, 8, "flash_attention"),           # unequal v dim: exact
])
def test_attention_routing_on_cpu(monkeypatch, force, sq, skv, dv, want):
    """CPU tensors (or FORCE = "ref") take the plain route the reference
    takes off the TPU, and never launch a kernel."""
    monkeypatch.setattr(ops, "FORCE", force)
    calls = _spy(monkeypatch, tref, ["flash_attention", "flash_attention_chunked"])
    ops.reset_launch_counts()
    q, k = torch.zeros((1, 1, sq, 16)), torch.zeros((1, 1, skv, 16))
    out = ops.flash_attention(q, k, torch.zeros((1, 1, skv, dv)))
    assert calls == [want] and out.shape == (1, 1, sq, dv)
    assert sum(ops.launch_counts().values()) == 0


@pytest.mark.parametrize("force", [None, "ref"])
@pytest.mark.parametrize("l,chunk,want", [
    (255, 128, "ssd_scan"), (256, 128, "ssd_scan_chunked"), (64, 32, "ssd_scan_chunked"),
    (63, 32, "ssd_scan")])
def test_ssd_routing_on_cpu(monkeypatch, force, l, chunk, want):
    monkeypatch.setattr(ops, "FORCE", force)
    monkeypatch.setattr(ops, "PLAIN_SSD_CHUNK", chunk)
    calls = _spy(monkeypatch, tref, ["ssd_scan", "ssd_scan_chunked"])
    ops.reset_launch_counts()
    rng = np.random.default_rng(l)
    x, a, bb, c = (_t(t) for t in _ssd_inputs(rng, 1, l, 2, 4, 4))
    out = ops.ssd_scan(x, a, bb, c)
    assert calls == [want] and out.shape == x.shape
    assert sum(ops.launch_counts().values()) == 0


def test_ops_equal_the_reference_ops_on_cpu():
    """The port's dispatch against the reference's on the same long input:
    both take their chunked forms."""
    rng = np.random.default_rng(8)
    q, k, v = _randn(rng, (1, 2, 1500, 16)), _randn(rng, (1, 1, 1500, 16)), _randn(rng, (1, 1, 1500, 16))
    got = _np(ops.flash_attention(_t(q), _t(k), _t(v)))
    np.testing.assert_allclose(got, _np(jops.flash_attention(_j(q), _j(k), _j(v))),
                               rtol=1e-4, atol=1e-4)
    x, a, bb, c = _ssd_inputs(rng, 1, 300, 2, 8, 4)
    got = _np(ops.ssd_scan(_t(x), _t(a), _t(bb), _t(c)))
    np.testing.assert_allclose(got, _np(jops.ssd_scan(_j(x), _j(a), _j(bb), _j(c))), **SSD)


def test_wrappers_run_the_plain_version_on_cpu():
    rng = np.random.default_rng(9)
    q, k, v = (_t(_randn(rng, (1, 2, 20, 16))) for _ in range(3))
    before = dict(ops.launch_counts())
    assert torch.equal(tfa.flash_attention(q, k, v), tref.flash_attention(q, k, v))
    x, a, bb, c = (_t(t) for t in _ssd_inputs(rng, 1, 20, 2, 4, 4))
    assert torch.equal(tssd.ssd_scan(x, a, bb, c), tref.ssd_scan(x, a, bb, c))
    assert ops.launch_counts() == before


def test_wrappers_raise_on_other_devices():
    q = torch.zeros((1, 2, 4, 16), device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)
    x = torch.zeros((1, 4, 2, 4), device="meta")
    with pytest.raises(ValueError):
        tssd.ssd_scan(x, torch.zeros((1, 4, 2), device="meta"), x, x)


def test_cuda_tensors_take_the_kernel_route(monkeypatch):
    """A CUDA tensor never reaches a plain version, even with unequal head
    dims (MLA): the wrapper checks its inputs and raises (the checks are
    replaced here to observe the route without a card)."""
    class FakeCuda:
        device = torch.device("cuda")
        shape = (1, 2, 4, 16)

    def kernel_route(*args):
        raise RuntimeError("kernel route")

    monkeypatch.setattr(tfa, "_check", kernel_route)
    monkeypatch.setattr(tssd, "_check", kernel_route)
    with pytest.raises(RuntimeError, match="kernel route"):
        ops.flash_attention(FakeCuda(), FakeCuda(), FakeCuda())
    with pytest.raises(RuntimeError, match="kernel route"):
        ops.ssd_scan(FakeCuda(), FakeCuda(), FakeCuda(), FakeCuda())
