"""Phase-1 kernels: DBSCAN's fused ε-neighbour count and one min-label
sweep, dense and over a list of active tile pairs, and K-Means' squared
distance matrix (CUDA source: ``csrc/pairwise_dist.cu``).

Counterpart of the Pallas kernels in ``repro/kernels/pairwise_dist.py``
(``neighbor_count``, ``min_label_sweep``, ``neighbor_count_sparse``,
``min_label_sweep_sparse``, ``pairwise_dist_sq``).  A CUDA tensor launches the kernel on the
current stream; a CPU tensor runs the plain version in ``ref``; any
other device raises.  ``launches`` counts kernel launches per wrapper
and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

TILE = 256            # columns per shared-memory tile (csrc kThreads/kTile)
TARGET_BLOCKS = 1024  # enough blocks to fill 132 SMs several times over

launches = {"neighbor_count": 0, "min_label_sweep": 0,
            "neighbor_count_sparse": 0, "min_label_sweep_sparse": 0,
            "pairwise_dist_sq": 0}

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
    lib.neighbor_count_sparse_launch.argtypes = [
        _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, _P, _P, _P]
    lib.neighbor_count_sparse_launch.restype = ctypes.c_int
    lib.min_label_sweep_sparse_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, _P, _P, _P]
    lib.min_label_sweep_sparse_launch.restype = ctypes.c_int
    lib.pairwise_dist_sq_launch.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int, _P, _P]
    lib.pairwise_dist_sq_launch.restype = ctypes.c_int
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


def pairwise_dist_sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances x (n, 2) × y (m, 2) float32 → (n, m) float32,
    clipped at 0, bit for bit ``ref.pairwise_dist_sq``.  Points are 2-D,
    as everywhere on DDC's path: any other width raises ``ValueError``."""
    if _device_kind(x) == "cpu":
        return ref.pairwise_dist_sq(x, y)
    n = _check_points(x)
    m = _check_points(y)
    if y.device != x.device:
        raise ValueError(f"x on {x.device}, y on {y.device}")
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n and m:
        _launch(x, _lib().pairwise_dist_sq_launch, "pairwise_dist_sq",
                x.data_ptr(), y.data_ptr(), n, m, out.data_ptr())
    return out


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


def _check_tile_pairs(x: torch.Tensor, pairs, bt: int) -> tuple[int, int]:
    """The sparse kernels' shape rules: n a multiple of ``bt``, ``bt`` a
    multiple of 32, and the CSR row offsets (T + 1,) and column tiles
    (T²,) as contiguous int32 on x's device.  Returns (rows per block,
    column-list splits)."""
    n = x.shape[0]
    if bt <= 0 or bt % 32 or n % bt:
        raise ValueError(f"the sparse kernels need n ({n}) a multiple of bt ({bt}) "
                         "and bt a multiple of 32")
    t = n // bt
    for name, v, size in (("row_ptr", pairs.row_ptr, t + 1), ("cols", pairs.cols, t * t)):
        if v.device != x.device or v.dtype != torch.int32 or v.shape != (size,) \
                or not v.is_contiguous():
            raise ValueError(f"pairs.{name} must be contiguous ({size},) int32 on "
                             f"{x.device}, got {tuple(v.shape)} {v.dtype} on {v.device}")
    rows_per_block = max(r for r in range(32, TILE + 1, 32) if bt % r == 0)
    blocks = n // rows_per_block
    return rows_per_block, max(1, min(t, -(-TARGET_BLOCKS // blocks)))


def neighbor_count_sparse(x: torch.Tensor, mask: torch.Tensor, eps, pairs,
                          *, bt: int) -> torch.Tensor:
    """``neighbor_count`` over the active tile pairs of spatially sorted
    points (n a multiple of ``bt``); ``pairs``: an ``ops.TilePairs``."""
    if _device_kind(x) == "cpu":
        return ref.neighbor_count_sparse(x, mask, eps, pairs.rows, pairs.cols,
                                         pairs.flags, bt)
    n = _check_points(x, (mask, torch.bool))
    rpb, s = _check_tile_pairs(x, pairs, bt)
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    part = torch.empty((s, n), dtype=torch.int32, device=x.device) if s > 1 else None
    lib = _lib()
    _launch(x, lib.neighbor_count_sparse_launch, "neighbor_count_sparse",
            x.data_ptr(), mask.data_ptr(), pairs.row_ptr.data_ptr(),
            pairs.cols.data_ptr(), n, bt, rpb, ref.eps_sq_f32(eps), s,
            None if part is None else part.data_ptr(), out.data_ptr())
    return out


def min_label_sweep_sparse(x: torch.Tensor, mask: torch.Tensor, labels: torch.Tensor,
                           core: torch.Tensor, eps, pairs, *, bt: int) -> torch.Tensor:
    """``min_label_sweep`` over the active tile pairs of spatially sorted
    points (n a multiple of ``bt``); ``pairs``: an ``ops.TilePairs``."""
    if _device_kind(x) == "cpu":
        return ref.min_label_sweep_sparse(x, mask, labels, core, eps, pairs.rows,
                                          pairs.cols, pairs.flags, bt)
    n = _check_points(x, (mask, torch.bool), (labels, torch.int32), (core, torch.bool))
    rpb, s = _check_tile_pairs(x, pairs, bt)
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    part = torch.empty((s, n), dtype=torch.int32, device=x.device) if s > 1 else None
    lib = _lib()
    _launch(x, lib.min_label_sweep_sparse_launch, "min_label_sweep_sparse",
            x.data_ptr(), mask.data_ptr(), labels.data_ptr(), core.data_ptr(),
            pairs.row_ptr.data_ptr(), pairs.cols.data_ptr(), n, bt, rpb,
            ref.eps_sq_f32(eps), s, None if part is None else part.data_ptr(),
            out.data_ptr())
    return out
