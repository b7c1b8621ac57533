"""Mamba-2 SSD chunked scan, on two routes chosen by dtype and shape
(``route``):

- ``"tc"`` (CUDA source ``csrc/ssd_scan_tc.cu``): bfloat16 at (dh, ds) in
  ``TC_SHAPES``, on Hopper's tensor cores (wgmma, float32 accumulation,
  TMA loads, chunks of 64).  x, b and c must sit on 16-byte boundaries
  (strides over (batch, step, head) multiples of 8 elements; a stride of 0
  is read as a broadcast axis), which every contiguous tensor and the
  Mamba layer's views (``layers._mamba_ssd_inputs``) do.
- ``"simt"`` (CUDA source ``csrc/ssd_scan.cu``): float32, and bfloat16 at
  any other shape, in IEEE float32 on the CUDA cores (no TF32), chunks of
  32.

Counterpart of the Pallas kernel ``repro/kernels/ssd_scan.py::ssd_scan``:
intra-chunk (C·Bᵀ ⊙ decay)·X plus the carried (ds, dh) state.  A CUDA
tensor launches the route's kernel on the current stream (any length: the
kernels handle a ragged last chunk themselves); a route's build or launch
error raises and no other route is tried; a CPU tensor runs
``ref.ssd_scan``; any other device raises.  ``launches`` counts kernel
launches of both routes and nothing else; ``route_launches`` counts them
by route.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

CHUNK = {"tc": 64, "simt": 32}  # steps per chunk of each route's kernel
MAX_DS = 256    # state size the simt kernel's shared memory covers
TC_SHAPES = ((64, 128),)  # (dh, ds) of the tensor-core kernel (bfloat16 only)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"ssd_scan": 0}
route_launches = {"tc": 0, "simt": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def route(dtype: torch.dtype, dh: int, ds: int) -> str:
    """The kernel a CUDA call takes: ``"tc"`` for bfloat16 at a (dh, ds) in
    ``TC_SHAPES`` (the SSM heads of mamba2-1.3b and jamba-1.5-large),
    ``"simt"`` otherwise."""
    return "tc" if dtype == torch.bfloat16 and (dh, ds) in TC_SHAPES else "simt"


@functools.cache
def _lib(name: str):
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if name == "ssd_scan":
        fn.argtypes = [_P] * 5 + [_I] * 6 + [_L] * 12 + [_P]
    else:
        fn.argtypes = [_P] * 5 + [_I] * 3 + ([_L] * 3 + [_I] * 2) * 3 + [_L] * 3 + [_P]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _tma_strides(name: str, t: torch.Tensor) -> list[int]:
    """(batch, step, head) element strides and (batch, head) read flags as
    the tensor-core kernel's TMA maps take them: strides multiples of 8 on
    a 16-byte-aligned pointer.  An axis of extent 1 or stride 0 is not read
    (flag 0, coordinate 0): its stride is never used and is replaced by
    the next inner axis's span."""
    strides, flags, inner = {}, {}, t.shape[-1]
    for ax in (1, 2, 0):  # step, head, batch: the maps' order from the inside out
        read = t.shape[ax] > 1 and t.stride(ax) != 0
        st = t.stride(ax) if read else inner
        strides[ax], flags[ax] = st, int(read)
        inner = st * (t.shape[ax] if read else 1)
    if t.data_ptr() % 16 or any(st % 8 for st in strides.values()) or (
            t.shape[1] > 1 and t.stride(1) == 0):
        raise ValueError(f"the tensor-core route needs {name} on 16-byte boundaries (strides "
                         f"over batch, step and head multiples of 8 elements, the step's not "
                         f"0), got strides {t.stride()} at offset {t.data_ptr() % 16} bytes")
    return [strides[0], strides[1], strides[2], flags[0], flags[2]]


def _check(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 4 or c.dim() != 4:
        raise ValueError(f"expected x (b, l, h, dh), a (b, l, h), b/c (b, l, h, ds), got "
                         f"{tuple(x.shape)}, {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, l, h, _ = x.shape
    ds = b.shape[-1]
    if a.shape != (bsz, l, h) or b.shape != (bsz, l, h, ds) or c.shape != b.shape:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)}")
    if not 4 <= ds <= MAX_DS or ds % 4:
        raise ValueError(f"state size {ds}: the kernel takes multiples of 4 up to {MAX_DS}")
    for name, t, dtype in (("x", x, x.dtype), ("a", a, torch.float32), ("b", b, x.dtype),
                           ("c", c, x.dtype)):
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {x.device}, got {t.dtype} on "
                             f"{t.device}")
        if name != "a" and t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last axis, strides {t.stride()}")


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x: (bsz, l, h, dh); a: (bsz, l, h) float32 log-decay; b, c: (bsz, l,
    h, ds), any strides over the first three axes (16-byte aligned on the
    ``"tc"`` route).  Returns y (bsz, l, h, dh) in x's dtype (float32 or
    bfloat16), computed in float32."""
    if x.device.type == "cpu":
        return ref.ssd_scan(x, a, b, c)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, a, b, c)
    return _launch(route(x.dtype, x.shape[-1], b.shape[-1]), x, a, b, c)


def _launch(kind: str, x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """Launch route ``kind``'s kernel on checked CUDA inputs.  The public
    entry takes ``route``'s choice; ``chip_smoke.py`` and
    ``tools/ssd_tc_ab.py`` also time the ``"simt"`` kernel on bfloat16
    inputs beside the ``"tc"`` one."""
    bsz, l, h, dh = x.shape
    if kind == "tc":
        name = "ssd_scan_tc"
        args = [bsz, l, h, *(v for n, t in (("x", x), ("b", b), ("c", c))
                             for v in _tma_strides(n, t)), *a.stride()]
    else:
        name = "ssd_scan"
        args = [_DTYPES[x.dtype], bsz, l, h, dh, b.shape[-1], *x.stride()[:3], *a.stride(),
                *b.stride()[:3], *c.stride()[:3]]
    y = torch.empty((bsz, l, h, dh), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    fn, err = _lib(name)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(), *args,
                  torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        raise _build.KernelLaunchError(f"{name}: error {code} ({err(code).decode()})")
    launches["ssd_scan"] += 1
    route_launches[kind] += 1
    return y
