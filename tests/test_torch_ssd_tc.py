"""The tensor-core route of the port's SSD scan (B8), on the CPU.

``csrc/ssd_scan_tc.cu`` runs only on the card, where
tests/test_torch_gpu.py and chip_smoke.py hold it against the plain
version.  Here:

- ``ssd_scan.route`` is held to its rule (bfloat16 at (dh, ds) = (64, 128)
  takes the tensor cores, everything else the float32 CUDA-core kernel)
  for every dtype and (dh, ds) that chip_smoke.py's SSD_SWEEP and the ten
  configurations use;
- ``_tc_numerics`` repeats the kernel's arithmetic in plain torch: chunks
  of 64 steps, cum by the kernel's shuffle-scan order in float32, c·bᵀ of
  bf16 values summed in float32, the decay selected (not multiplied) away
  above the diagonal, and the three float32 operands that wgmma takes in
  bf16 (G, the carried state S_in and w ⊙ x) each split into hi = bf16(v)
  and lo = bf16(v − hi), both multiplied and accumulated in float32, y
  rounded once to bf16.  It must sit within chip_smoke.py's ``bf16_tol``
  (one bf16 ulp: rtol 2^-7, atol 2^-12·max|plain|) of the port's
  ``ref.ssd_scan_chunked`` and of the reference package's
  ``ref.ssd_scan`` (and its ``ref.ssd_scan_chunked`` where that is
  finite) on the same numpy inputs: the sweep's bf16 tensor-core cases and
  a mamba2-1.3b-shaped case (a decay of about −0.7 a step, l 640, c
  broadcast over the heads);
- for each of the three splits, the same arithmetic with that operand
  rounded once to bf16 breaks the gate on one of those cases: that is why
  the kernel keeps each split;
- a CUDA tensor goes to the kernel of its route and nowhere else: a launch
  or tensor-map error raises ``KernelLaunchError``, and no other route is
  tried.
"""
import contextlib
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402

L = 64  # the kernel's chunk
PLAIN_CHUNK = 128  # ops.PLAIN_SSD_CHUNK, the plain route chip_smoke.py compares with

# chip_smoke.py's bf16 SSD_SWEEP cases that take the tensor cores (dh 64,
# ds 128): a ragged l, l < 64, l = 1, one whole chunk, b > 1, and the Mamba
# layer's views ("mamba": x a slice of the conv output, c broadcast).
# (b, l, h, layout)
TC_SWEEP = [
    (1, 300, 4, "dense"),
    (1, 50, 2, "dense"),
    (1, 1, 2, "dense"),
    (1, 64, 2, "dense"),
    (3, 200, 3, "dense"),
    (2, 130, 4, "mamba"),
    (1, 1000, 2, "mamba"),
]
MAMBA2_SHAPE = (2, 640, 4, "mamba2")


def _inputs(case, seed):
    """x (b, l, h, 64), a (b, l, h), b, c (b, l, h, 128) as numpy float32
    (x, b, c already bf16 values).  "dense" and "mamba" as chip_smoke.py's
    sweep draws them (normal values, a = −0.1·|normal|); "mamba2" as the
    layer hands them over at init: silu'd x and c, b = silu(·)·dt with dt in
    [0.001, 0.1], a = −A·dt with A in [4, 24] per head (−0.7 a step on
    average)."""
    b, l, h, layout = case
    rng = np.random.default_rng(seed)
    if layout == "mamba2":
        silu = lambda v: v / (1.0 + np.exp(-v))  # noqa: E731
        x = silu(rng.normal(size=(b, l, h, 64)) * 0.5)
        c = np.broadcast_to(silu(rng.normal(size=(b, l, 1, 128)) * 0.5), (b, l, h, 128))
        dt = rng.uniform(0.001, 0.1, size=(b, l, h))
        bm = silu(rng.normal(size=(b, l, 1, 128)) * 0.5) * dt[..., None]
        a = -rng.uniform(4.0, 24.0, size=(1, 1, h)) * dt
    elif layout == "mamba":
        xbc = rng.normal(size=(b, l, h * 64 + 256))
        x = xbc[..., :h * 64].reshape(b, l, h, 64)
        bm = np.broadcast_to(xbc[..., h * 64:h * 64 + 128][:, :, None] * 0.5, (b, l, h, 128))
        c = np.broadcast_to(xbc[..., h * 64 + 128:][:, :, None], (b, l, h, 128))
        a = -0.1 * np.abs(rng.normal(size=(b, l, h)))
    else:
        x, bm, c = (rng.normal(size=(b, l, h, n)) for n in (64, 128, 128))
        a = -0.1 * np.abs(rng.normal(size=(b, l, h)))
    bf = [torch.from_numpy(np.ascontiguousarray(v, np.float32)).bfloat16().float().numpy()
          for v in (x, bm, c)]
    return bf[0], a.astype(np.float32), bf[1], bf[2]


def _scan_cum(a):
    """The kernel's cum over the last axis (64 steps), in its order: lane l
    holds steps 2l and 2l + 1; their sum is scanned over the 32 lanes
    (Hillis–Steele, a lane adds the one `off` below it for off = 1, 2, 4,
    ...), the lane's exclusive prefix is its neighbour's inclusive one, and
    cum[2l] = prefix + a[2l], cum[2l + 1] = cum[2l] + a[2l + 1]."""
    a0, a1 = a[..., 0::2], a[..., 1::2]
    inc = a0 + a1
    off = 1
    while off < 32:
        up = torch.zeros_like(inc)
        up[..., off:] = inc[..., :-off]
        inc = torch.cat([inc[..., :off], inc[..., off:] + up[..., off:]], dim=-1)
        off *= 2
    exc = torch.zeros_like(inc)
    exc[..., 1:] = inc[..., :-1]
    c0 = exc + a0
    return torch.stack([c0, c0 + a1], dim=-1).flatten(-2)


def _parts(v, split):
    """v as the bf16 operands wgmma reads: (hi, lo) or (hi,)."""
    hi = v.bfloat16().float()
    return (hi, (v - hi).bfloat16().float()) if split else (hi,)


def _tc_numerics(x, a, b, c, *, split_g=True, split_s=True, split_w=True):
    """The tensor-core kernel's arithmetic in plain torch (see the module
    docstring); ``split_*=False`` rounds that operand once to bf16."""
    bsz, l, h, dh = x.shape
    ds = b.shape[-1]
    n = -(-l // L)
    pad = n * L - l

    def heads(t):  # (bsz, l, h, ...) → (bsz, h, n*L, ...), zeros past l
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 3) + (0, 0, 0, pad))
        return t.transpose(1, 2)

    xs, bs, cs, as_ = heads(x), heads(b), heads(c), heads(a)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool))
    s = torch.zeros((bsz, h, ds, dh))
    ys = []
    for i in range(n):
        sl = slice(i * L, (i + 1) * L)
        xc, bc, cc = xs[:, :, sl], bs[:, :, sl], cs[:, :, sl]
        cum = _scan_cum(as_[:, :, sl])
        g = cc @ bc.transpose(-1, -2)
        g = torch.where(causal, g * torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
        acc = sum(cc @ part for part in _parts(s, split_s))
        acc = acc * torch.exp(cum)[..., None]
        for part in _parts(g, split_g):
            acc = acc + part @ xc
        ys.append(acc)
        wx = torch.exp(cum[..., -1:] - cum)[..., None] * xc
        s = s * torch.exp(cum[..., -1])[..., None, None]
        for part in _parts(wx, split_w):
            s = s + bc.transpose(-1, -2) @ part
    return torch.cat(ys, dim=2)[:, :, :l].transpose(1, 2).bfloat16()


def _violations(got, want) -> int:
    """Entries outside chip_smoke.py's bf16_tol of ``want``."""
    g, w = got.double(), want.double()
    atol = 2.0 ** -12 * float(w.abs().max())
    return int(((g - w).abs() > atol + 2.0 ** -7 * w.abs()).sum())


def _torch(x, a, b, c):
    return (torch.from_numpy(x).bfloat16(), torch.from_numpy(a), torch.from_numpy(b).bfloat16(),
            torch.from_numpy(c).bfloat16())


def _jax(x, a, b, c):
    return (jnp.asarray(x, jnp.bfloat16), jnp.asarray(a), jnp.asarray(b, jnp.bfloat16),
            jnp.asarray(c, jnp.bfloat16))


def _from_jax(y):
    return torch.from_numpy(np.array(y.astype(jnp.float32))).bfloat16()


@functools.cache
def _case(case):
    """A case's inputs and the plain results it is held to: the port's
    chunked version at the plain route's chunk, the reference package's
    sequential scan, and its chunked version where that is finite (it
    multiplies exp(positive) by 0 above the diagonal: NaN at a real decay)."""
    inputs = _inputs(case, sum(case[:3]))
    t, j = _torch(*inputs), _jax(*inputs)
    wants = {"port chunked": tref.ssd_scan_chunked(*t, chunk=PLAIN_CHUNK),
             "jax sequential": _from_jax(jref.ssd_scan(*j))}
    chunked = _from_jax(jref.ssd_scan_chunked(*j, chunk=PLAIN_CHUNK))
    if bool(torch.isfinite(chunked.float()).all()):
        wants["jax chunked"] = chunked
    return t, wants


# chip_smoke.py's SSD_SWEEP (dh, ds), float32 and bfloat16.
@pytest.mark.parametrize("dh,ds", [(16, 8), (32, 16), (8, 4), (64, 128), (40, 256), (64, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_by_dtype_and_shape(dtype, dh, ds):
    want = "tc" if dtype == torch.bfloat16 and (dh, ds) == (64, 128) else "simt"
    assert tssd.route(dtype, dh, ds) == want


@pytest.mark.parametrize("arch", configs.all_archs())
def test_route_of_each_configuration(arch):
    """The (dh, ds) each configuration hands the SSD kernel: mamba2-1.3b's
    and jamba-1.5-large's Mamba layers (64, 128) take the tensor cores in
    bf16; float32 always stays on the CUDA cores; the other eight have no
    Mamba layer."""
    cfg = configs.get_config(arch)
    if not any(kind == "mamba" for kind, _ in cfg.layer_kinds()):
        assert arch not in ("mamba2-1.3b", "jamba-1.5-large-398b")
        return
    assert arch in ("mamba2-1.3b", "jamba-1.5-large-398b")
    assert tssd.route(torch.bfloat16, cfg.ssm_head_dim, cfg.ssm_state) == "tc"
    assert tssd.route(torch.float32, cfg.ssm_head_dim, cfg.ssm_state) == "simt"


@pytest.mark.parametrize("case", TC_SWEEP + [MAMBA2_SHAPE])
def test_tc_numerics_within_one_bf16_ulp(case):
    (x, a, b, c), wants = _case(case)
    assert tssd.route(x.dtype, x.shape[-1], b.shape[-1]) == "tc"
    got = _tc_numerics(x, a, b, c)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert len(wants) >= 2
    for name, want in wants.items():
        assert _violations(got, want) == 0, name


# Each split against the case where rounding that operand once shows.
@pytest.mark.parametrize("split,case", [("split_g", MAMBA2_SHAPE), ("split_s", TC_SWEEP[0]),
                                        ("split_w", TC_SWEEP[0])])
def test_each_split_is_needed(split, case):
    """Rounding G, S_in or w ⊙ x once to bf16 (no lo part) moves some
    outputs by more than one bf16 ulp from the float32 plain version; the
    kernel's split keeps them within it."""
    (x, a, b, c), wants = _case(case)
    want = wants["port chunked"]
    assert _violations(_tc_numerics(x, a, b, c, **{split: False}), want) > 0
    assert _violations(_tc_numerics(x, a, b, c), want) == 0


@pytest.mark.parametrize("dtype,dh,ds,kind", [(torch.bfloat16, 64, 128, "tc"),
                                              (torch.bfloat16, 64, 256, "simt"),
                                              (torch.bfloat16, 16, 8, "simt"),
                                              (torch.float32, 64, 128, "simt")])
def test_cuda_tensors_launch_their_routes_kernel_only(monkeypatch, dtype, dh, ds, kind):
    """The wrapper's dispatch, without a card: a (stand-in) CUDA tensor is
    launched on its route's kernel once, and that kernel's launch error
    reaches the caller; the other route is never tried."""
    def cuda(*shape):
        return types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype, shape=shape)

    tried = []

    def launch(route, *args):
        tried.append(route)
        raise _build.KernelLaunchError(f"{route}: refused")

    monkeypatch.setattr(tssd, "_check", lambda *args: None)
    monkeypatch.setattr(tssd, "_launch", launch)
    before = dict(tssd.route_launches)
    with pytest.raises(_build.KernelLaunchError, match=kind):
        tssd.ssd_scan(cuda(1, 8, 2, dh), cuda(1, 8, 2), cuda(1, 8, 2, ds), cuda(1, 8, 2, ds))
    assert tried == [kind] and tssd.route_launches == before


def test_tensor_core_encode_error_raises(monkeypatch):
    """The tensor-core launch itself, its library stood in for: the
    Mamba layer's views reach the C entry as TMA strides and read flags (c
    broadcast over the heads: flag 0), and an error code from it (here the
    tensor-map encoder's) raises KernelLaunchError; the CUDA-core library
    is never asked for, and no launch is counted."""
    xbc = torch.zeros((2, 130, 4 * 64 + 256), dtype=torch.bfloat16)
    x = xbc[..., :256].reshape(2, 130, 4, 64)
    b = torch.zeros((2, 130, 4, 128), dtype=torch.bfloat16)
    c = xbc[..., 384:][:, :, None, :].expand(2, 130, 4, 128)
    a = torch.zeros((2, 130, 4))
    calls, libs = [], []

    def fn(*args):
        calls.append(args)
        return 100001

    def lib(name):
        libs.append(name)
        return fn, lambda code: b"cuTensorMapEncodeTiled refused the tensor map"

    monkeypatch.setattr(tssd, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    before = (dict(tssd.route_launches), dict(tssd.launches))
    with pytest.raises(_build.KernelLaunchError, match="refused the tensor map"):
        tssd._launch(tssd.route(x.dtype, 64, 128), x, a, b, c)
    assert libs == ["ssd_scan_tc"] and len(calls) == 1
    assert (dict(tssd.route_launches), dict(tssd.launches)) == before
    step = 4 * 64 + 256
    assert list(calls[0][5:]) == [
        2, 130, 4,
        130 * step, step, 64, 1, 1,                        # x: batch, step, head; both read
        130 * 4 * 128, 4 * 128, 128, 1, 1,                 # b, contiguous
        130 * step, step, step * 130, 1, 0,                # c: the head axis broadcast
        *a.stride(), 7]
