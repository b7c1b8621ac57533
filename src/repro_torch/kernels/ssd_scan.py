"""Mamba-2 SSD chunked scan (CUDA source: ``csrc/ssd_scan.cu``).

Counterpart of the Pallas kernel ``repro/kernels/ssd_scan.py::ssd_scan``:
intra-chunk (C·Bᵀ ⊙ decay)·X plus the carried (ds, dh) state.  A CUDA
tensor launches the kernel on the current stream (any length: the kernel
handles a ragged last chunk itself); a CPU tensor runs ``ref.ssd_scan``;
any other device raises.  ``launches`` counts kernel launches and
nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

CHUNK = 32      # steps per chunk (csrc kLc), chosen for shared memory
MAX_DS = 256    # state size the kernel's shared memory covers
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"ssd_scan": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.cache
def _lib():
    lib = _build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = [_P] * 5 + [_I] * 6 + [_L] * 12 + [_P]
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


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
    h, ds), any strides over the first three axes.  Returns y (bsz, l, h,
    dh) in x's dtype (float32 or bfloat16), computed in float32."""
    if x.device.type == "cpu":
        return ref.ssd_scan(x, a, b, c)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, a, b, c)
    bsz, l, h, dh = x.shape
    y = torch.empty((bsz, l, h, dh), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.ssd_scan_launch(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
            _DTYPES[x.dtype], bsz, l, h, dh, b.shape[-1], *x.stride()[:3], *a.stride(),
            *b.stride()[:3], *c.stride()[:3], torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        msg = lib.ssd_scan_error_string(code).decode()
        raise _build.KernelLaunchError(f"ssd_scan: CUDA error {code} ({msg})")
    launches["ssd_scan"] += 1
    return y
