"""Forward attention with an online softmax (CUDA source:
``csrc/flash_attention.cu``).

Counterpart of the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention``: GQA, right-aligned causal positions, an optional
sliding window, whole masked kv tiles skipped.  A CUDA tensor launches
the kernel on the current stream (any length: the kernel masks the
ragged edge itself); a CPU tensor runs ``ref.flash_attention``; any
other device raises.  ``launches`` counts kernel launches and nothing
else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

MIN_D, MAX_D = 16, 256  # head dims the kernel's buckets cover
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"flash_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.cache
def _lib():
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I] + [_L] * 9
        + [ctypes.c_float, _I, _I, _P])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window) -> None:
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be (batch, heads, seq, head_dim), got "
                             f"{tuple(t.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is {q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last axis, strides {t.stride()}")
    b, h, _, d = q.shape
    if v.shape[-1] != d or k.shape[-1] != d:
        raise ValueError(f"the kernel needs equal q/k/v head dims, got {d}, "
                         f"{k.shape[-1]}, {v.shape[-1]} (MLA pads v)")
    if not MIN_D <= d <= MAX_D:
        raise ValueError(f"head dim {d} outside the kernel's {MIN_D}..{MAX_D}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] < 1 or h % k.shape[1]:
        raise ValueError(f"k/v must be (b, hkv, skv, d) with h % hkv == 0, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)} for q {tuple(q.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    window: int | None = None) -> torch.Tensor:
    """q: (b, h, sq, d); k, v: (b, hkv, skv, d) with h % hkv == 0, any
    strides over the first three axes.  Returns (b, h, sq, d) in q's
    dtype (float32 or bfloat16), computed in float32."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, scale=scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, window)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            b, h, hkv, sq, skv, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(bool(causal)), int(window or 0),
            torch.cuda.current_stream(q.device).cuda_stream)
    if code != 0:
        msg = lib.flash_attention_error_string(code).decode()
        raise _build.KernelLaunchError(f"flash_attention: CUDA error {code} ({msg})")
    launches["flash_attention"] += 1
    return out
