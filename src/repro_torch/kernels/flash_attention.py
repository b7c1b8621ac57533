"""Forward attention with an online softmax, on two routes chosen by dtype
and head dim (``route``):

- ``"tc"`` (CUDA source ``csrc/flash_attention_tc.cu``): bfloat16 with d
  in ``TC_HEAD_DIMS``, on Hopper's tensor cores (wgmma, float32
  accumulation, TMA loads).  q, k and v must sit on 16-byte boundaries
  (strides over (batch, head, seq) multiples of 8 elements), which every
  contiguous tensor and ``layers.gqa_qkv``'s transposed views do.
- ``"simt"`` (CUDA source ``csrc/flash_attention.cu``): float32, and
  bfloat16 at any other head dim, in IEEE float32 on the CUDA cores (no
  TF32).

Counterpart of the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention``: GQA, right-aligned causal positions, an optional
sliding window, whole masked kv tiles skipped.  A CUDA tensor launches
the route's kernel on the current stream (any length: the kernels mask
the ragged edge themselves); a route's build or launch error raises and
no other route is tried; a CPU tensor runs ``ref.flash_attention``; any
other device raises.  ``launches`` counts kernel launches of both routes
and nothing else; ``route_launches`` counts them by route.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

MIN_D, MAX_D = 16, 256  # head dims the simt kernel's buckets cover
TC_HEAD_DIMS = (64, 128)  # head dims of the tensor-core kernel (bfloat16 only)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"flash_attention": 0}
route_launches = {"tc": 0, "simt": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call takes: ``"tc"`` for bfloat16 at a head dim in
    ``TC_HEAD_DIMS``, ``"simt"`` otherwise."""
    return "tc" if dtype == torch.bfloat16 and d in TC_HEAD_DIMS else "simt"


@functools.cache
def _lib(name: str):
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = ([_P, _P, _P, _P] + ([_I] if name == "flash_attention" else [])
                   + [_I] * 6 + [_L] * 9 + [ctypes.c_float, _I, _I, _P])
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _tma_strides(name: str, t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, head, seq) element strides as the tensor-core kernel's TMA
    maps take them: multiples of 8 on a 16-byte-aligned pointer.  The
    stride of an axis of extent 1 is never used and is replaced by the
    next inner axis's span."""
    out, inner = [], t.shape[-1]
    for ax in (2, 1, 0):
        st = t.stride(ax) if t.shape[ax] > 1 else inner
        out.append(st)
        inner = st * t.shape[ax]
    if t.data_ptr() % 16 or any(st % 8 for st in out):
        raise ValueError(f"the tensor-core route needs {name} on 16-byte boundaries (strides "
                         f"over batch, head and seq multiples of 8 elements), got strides "
                         f"{t.stride()} at offset {t.data_ptr() % 16} bytes")
    return out[2], out[1], out[0]


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
    strides over the first three axes (16-byte aligned on the ``"tc"``
    route).  Returns (b, h, sq, d) in q's dtype (float32 or bfloat16),
    accumulated in float32."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, scale=scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, window)
    return _launch(route(q.dtype, q.shape[-1]), q, k, v, causal, scale, window)


def _launch(kind: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: float | None, window: int | None) -> torch.Tensor:
    """Launch route ``kind``'s kernel on checked CUDA inputs.  The public
    entry takes ``route``'s choice; ``chip_smoke.py`` also times the
    ``"simt"`` kernel on bfloat16 inputs beside the ``"tc"`` one."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if kind == "tc":
        name, lead = "flash_attention_tc", []
        strides = [st for name_t, t in (("q", q), ("k", k), ("v", v))
                   for st in _tma_strides(name_t, t)]
    else:
        name, lead = "flash_attention", [_DTYPES[q.dtype]]
        strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]]
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn, err = _lib(name)
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *lead,
                  b, h, hkv, sq, skv, d, *strides, float(scale), int(bool(causal)),
                  int(window or 0), torch.cuda.current_stream(q.device).cuda_stream)
    if code != 0:
        raise _build.KernelLaunchError(f"{name}: error {code} ({err(code).decode()})")
    launches["flash_attention"] += 1
    route_launches[kind] += 1
    return out
