"""MoE dispatch gather, optionally quantised to int8 (CUDA source:
``csrc/moe_gather.cu``).

Counterpart of the Pallas kernel ``repro/kernels/moe_gather.py::
dispatch_gather``: slot i of the output gets token row ``idx[i]`` of x,
or zeros where ``idx[i] < 0``.  A CUDA tensor launches the kernel on the
current stream; a CPU tensor runs ``ref.dispatch_gather``; any other
device raises.  ``launches`` counts kernel launches (either mode) and
nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"dispatch_gather": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.cache
def _lib():
    lib = _build.load("moe_gather")
    lib.dispatch_gather_launch.argtypes = [_P] * 4 + [_I] * 4 + [_L, _I, _P]
    lib.dispatch_gather_launch.restype = ctypes.c_int
    lib.dispatch_gather_error_string.argtypes = [ctypes.c_int]
    lib.dispatch_gather_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, idx: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"expected x (t, d) and idx (S,), got {tuple(x.shape)}, "
                         f"{tuple(idx.shape)}")
    if idx.dtype != torch.int32 or idx.device != x.device:
        raise ValueError(f"idx must be int32 on {x.device}, got {idx.dtype} on {idx.device}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"x needs a contiguous last axis, strides {x.stride()}")
    if idx.numel() > 1 and idx.stride(0) != 1:
        raise ValueError(f"idx needs a unit stride, got {idx.stride()}")


def dispatch_gather(x: torch.Tensor, idx: torch.Tensor, *, quant: bool):
    """x: (t, d) float32 or bfloat16 with a contiguous last axis and any
    row stride (read in place: a row slice or a strided view needs no
    copy); idx: (S,) int32, −1 for an empty slot.  Returns (buf (S, d),
    scales (S,) float32): buf in x's dtype, or int8 with ``quant``, as
    ``ref.dispatch_gather`` defines them, bit for bit.  An id >= t gives
    an empty slot, as an id < 0 does (on every device); a row holding a
    NaN quantises to unspecified values."""
    if x.device.type == "cpu":
        return ref.dispatch_gather(x, idx, quant=quant)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, idx)
    t, d = x.shape
    s = idx.shape[0]
    buf = torch.empty((s, d), dtype=torch.int8 if quant else x.dtype, device=x.device)
    scales = torch.empty((s,), dtype=torch.float32, device=x.device)
    if s == 0:
        return buf, scales
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.dispatch_gather_launch(
            x.data_ptr(), idx.data_ptr(), buf.data_ptr(), scales.data_ptr(), _DTYPES[x.dtype],
            t, d, s, x.stride(0), int(quant), torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        msg = lib.dispatch_gather_error_string(code).decode()
        raise _build.KernelLaunchError(f"dispatch_gather: CUDA error {code} ({msg})")
    launches["dispatch_gather"] += 1
    return buf, scales
