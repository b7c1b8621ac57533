"""Phase-1 DBSCAN kernels: the fused ε-neighbour count and one min-label
sweep (CUDA source: ``csrc/pairwise_dist.cu``).

Counterpart of the Pallas kernels in ``repro/kernels/pairwise_dist.py``
(``neighbor_count``, ``min_label_sweep``).  A CUDA tensor launches the
kernel on the current stream; a CPU tensor runs the plain version in
``ref``; any other device raises.  ``launches`` counts kernel launches
per wrapper and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

TILE = 256            # columns per shared-memory tile (csrc kThreads/kTile)
TARGET_BLOCKS = 1024  # enough blocks to fill 132 SMs several times over

launches = {"neighbor_count": 0, "min_label_sweep": 0}

_P = ctypes.c_void_p


@functools.cache
def _lib():
    lib = _build.load("pairwise_dist")
    lib.neighbor_count_launch.argtypes = [
        _P, _P, ctypes.c_int, ctypes.c_float, ctypes.c_int, _P, _P, _P]
    lib.neighbor_count_launch.restype = ctypes.c_int
    lib.min_label_sweep_launch.argtypes = [
        _P, _P, _P, _P, ctypes.c_int, ctypes.c_float, ctypes.c_int, _P, _P, _P]
    lib.min_label_sweep_launch.restype = ctypes.c_int
    lib.pairwise_dist_error_string.argtypes = [ctypes.c_int]
    lib.pairwise_dist_error_string.restype = ctypes.c_char_p
    return lib


def _check_points(x: torch.Tensor, *vecs: tuple[torch.Tensor, torch.dtype]) -> int:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 2:
        raise ValueError(f"x must be (n, 2) float32, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x.shape[0]
    if n >= 2**31:
        raise ValueError(f"n = {n} does not fit the kernel's int32 indexing")
    for t, dtype in vecs:
        if t.device != x.device or t.dtype != dtype or t.shape != (n,) \
                or not t.is_contiguous():
            raise ValueError(
                f"expected contiguous ({n},) {dtype} on {x.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return n


def _splits(n: int) -> int:
    """Column splits so that row blocks × splits ≈ TARGET_BLOCKS; the row
    blocks and the column tiles are both TILE wide."""
    tiles = -(-n // TILE)
    return max(1, min(tiles, -(-TARGET_BLOCKS // tiles)))


def _launch(x: torch.Tensor, fn, name: str, *args) -> None:
    with torch.cuda.device(x.device):
        code = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        msg = _lib().pairwise_dist_error_string(code).decode()
        raise _build.KernelLaunchError(f"{name}: CUDA error {code} ({msg})")
    launches[name] += 1


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def neighbor_count(x: torch.Tensor, mask: torch.Tensor, eps) -> torch.Tensor:
    """Per point, the count of masked points within eps (self included);
    x: (n, 2) f32, mask: (n,) bool → (n,) i32."""
    if _device_kind(x) == "cpu":
        return ref.neighbor_count(x, mask, eps)
    n = _check_points(x, (mask, torch.bool))
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    s = _splits(n)
    part = torch.empty((s, n), dtype=torch.int32, device=x.device) if s > 1 else None
    lib = _lib()
    _launch(x, lib.neighbor_count_launch, "neighbor_count",
            x.data_ptr(), mask.data_ptr(), n, ref.eps_sq_f32(eps), s,
            None if part is None else part.data_ptr(), out.data_ptr())
    return out


def min_label_sweep(x: torch.Tensor, mask: torch.Tensor, labels: torch.Tensor,
                    core: torch.Tensor, eps) -> torch.Tensor:
    """One min-label sweep: per point, the min label over masked core
    points within eps, SENTINEL where there is none → (n,) i32."""
    if _device_kind(x) == "cpu":
        return ref.min_label_sweep(x, mask, labels, core, eps)
    n = _check_points(x, (mask, torch.bool), (labels, torch.int32), (core, torch.bool))
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    s = _splits(n)
    part = torch.empty((s, n), dtype=torch.int32, device=x.device) if s > 1 else None
    lib = _lib()
    _launch(x, lib.min_label_sweep_launch, "min_label_sweep",
            x.data_ptr(), mask.data_ptr(), labels.data_ptr(), core.data_ptr(), n,
            ref.eps_sq_f32(eps), s, None if part is None else part.data_ptr(),
            out.data_ptr())
    return out
