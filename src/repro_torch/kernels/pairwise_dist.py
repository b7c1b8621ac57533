"""Phase-1 kernels: DBSCAN's fused ε-neighbour count and one min-label
sweep, dense and over a list of active tile pairs, and K-Means' squared
distance matrix (CUDA sources: ``csrc/pair_sweep.cu`` for the counts and
the sweeps, which test each unordered pair of points once, and
``csrc/pairwise_dist.cu`` for the distance matrix).

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

SYM_DENSE_TILE = 256  # the dense items' square tiles (pair_sweep.cu kDenseTile)
SYM_TILES = (256, 128, 64, 32)  # the sparse items' sub-tile: the first that divides bt
INT32_MAX = 2**31 - 1  # the dense sweep's output starts here (its plain version's min)

launches = {"neighbor_count": 0, "min_label_sweep": 0,
            "neighbor_count_sparse": 0, "min_label_sweep_sparse": 0,
            "pairwise_dist_sq": 0}

_P = ctypes.c_void_p


@functools.cache
def _lib():
    lib = _build.load("pairwise_dist")
    lib.pairwise_dist_sq_launch.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int, _P, _P]
    lib.pairwise_dist_sq_launch.restype = ctypes.c_int
    lib.pairwise_dist_error_string.argtypes = [ctypes.c_int]
    lib.pairwise_dist_error_string.restype = ctypes.c_char_p
    return lib


def bind_sym(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare csrc/pair_sweep.cu's C entry points on a loaded library."""
    lib.neighbor_count_launch.argtypes = [_P, _P, ctypes.c_int, ctypes.c_float, _P, _P]
    lib.neighbor_count_launch.restype = ctypes.c_int
    lib.neighbor_count_sparse_launch.argtypes = [
        _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P, _P]
    lib.neighbor_count_sparse_launch.restype = ctypes.c_int
    lib.min_label_sweep_launch.argtypes = [
        _P, _P, _P, _P, ctypes.c_int, ctypes.c_float, _P, _P]
    lib.min_label_sweep_launch.restype = ctypes.c_int
    lib.min_label_sweep_sparse_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, _P, _P]
    lib.min_label_sweep_sparse_launch.restype = ctypes.c_int
    return lib


@functools.cache
def _sym_lib():
    return bind_sym(_build.load("pair_sweep"))


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
    """Per point, the count of masked points within eps (self included),
    0 for a masked-out point; x: (n, 2) f32, mask: (n,) bool → (n,) i32;
    bit for bit ``ref.neighbor_count`` on every input (see
    csrc/pair_sweep.cu)."""
    if _device_kind(x) == "cpu":
        return ref.neighbor_count(x, mask, eps)
    n = _check_points(x, (mask, torch.bool))
    out = torch.zeros((n,), dtype=torch.int32, device=x.device)
    if n:
        _launch(x, _sym_lib().neighbor_count_launch, "neighbor_count",
                x.data_ptr(), mask.data_ptr(), n, ref.eps_sq_f32(eps), out.data_ptr())
    return out


def min_label_sweep(x: torch.Tensor, mask: torch.Tensor, labels: torch.Tensor,
                    core: torch.Tensor, eps) -> torch.Tensor:
    """One min-label sweep: per point, the min label over masked core
    points within eps, SENTINEL where there is none → (n,) i32; bit for
    bit ``ref.min_label_sweep`` on every input (see csrc/pair_sweep.cu)."""
    if _device_kind(x) == "cpu":
        return ref.min_label_sweep(x, mask, labels, core, eps)
    n = _check_points(x, (mask, torch.bool), (labels, torch.int32), (core, torch.bool))
    out = torch.full((n,), INT32_MAX, dtype=torch.int32, device=x.device)
    if n:
        _launch(x, _sym_lib().min_label_sweep_launch, "min_label_sweep",
                x.data_ptr(), mask.data_ptr(), labels.data_ptr(), core.data_ptr(), n,
                ref.eps_sq_f32(eps), out.data_ptr())
    return out


def sym_tile(bt: int) -> int:
    """The sparse sweep's sub-tile for tiles of ``bt`` (a multiple of 32)."""
    return next(s for s in SYM_TILES if bt % s == 0)


def sym_work_items(n: int, pairs=None, *, bt: int | None = None) -> int:
    """Work items of one launch of csrc/pair_sweep.cu: the unordered pairs of
    the dense sweep's ceil(n / 256) tiles, or, given ``pairs`` and ``bt``,
    the T diagonal tiles' k(k+1)/2 sub-tile pairs and k² for each upper
    pair (k = bt / ``sym_tile(bt)``; reads ``pairs.n_up``, a host sync)."""
    if pairs is None:
        t = -(-n // SYM_DENSE_TILE)
        return t * (t + 1) // 2
    k = bt // sym_tile(bt)
    return n // bt * k * (k + 1) // 2 + int(pairs.n_up) * k * k


def _check_sparse(x: torch.Tensor, pairs, bt: int) -> None:
    """The sparse kernels' shape rules (n a multiple of ``bt``, ``bt`` a
    multiple of 32) and the upper list of ``pairs`` (``ops.TilePairs``)
    for tiles of ``bt``."""
    n = x.shape[0]
    if bt <= 0 or bt % 32 or n % bt:
        raise ValueError(f"the sparse kernels need n ({n}) a multiple of bt ({bt}) "
                         "and bt a multiple of 32")
    t = n // bt
    for name, shape in (("up_rows", (t * (t - 1) // 2,)), ("up_cols", (t * (t - 1) // 2,)),
                        ("n_up", ())):
        v = getattr(pairs, name, None)
        if not isinstance(v, torch.Tensor):
            raise ValueError(f"pairs has no upper list ({name}): build it with "
                             "ops.build_tile_pairs")
        if v.device != x.device or v.dtype != torch.int32 or v.shape != shape \
                or not v.is_contiguous():
            raise ValueError(f"pairs.{name} must be contiguous {shape} int32 on {x.device}, "
                             f"got {tuple(v.shape)} {v.dtype} on {v.device}")


def neighbor_count_sparse(x: torch.Tensor, mask: torch.Tensor, eps, pairs,
                          *, bt: int) -> torch.Tensor:
    """``neighbor_count`` over the active tile pairs of spatially sorted
    points (n a multiple of ``bt``); ``pairs``: an ``ops.TilePairs``.  The
    kernel walks the diagonal tiles and the upper list (``pairs.up_rows``,
    ...) and tests each unordered pair once; bit for bit
    ``ref.neighbor_count_sparse`` on every input."""
    if _device_kind(x) == "cpu":
        return ref.neighbor_count_sparse(x, mask, eps, pairs.rows, pairs.cols,
                                         pairs.flags, bt)
    n = _check_points(x, (mask, torch.bool))
    _check_sparse(x, pairs, bt)
    out = torch.zeros((n,), dtype=torch.int32, device=x.device)
    if n:
        _launch(x, _sym_lib().neighbor_count_sparse_launch, "neighbor_count_sparse",
                x.data_ptr(), mask.data_ptr(), pairs.up_rows.data_ptr(),
                pairs.up_cols.data_ptr(), pairs.n_up.data_ptr(), n, bt, sym_tile(bt),
                ref.eps_sq_f32(eps), out.data_ptr())
    return out


def min_label_sweep_sparse(x: torch.Tensor, mask: torch.Tensor, labels: torch.Tensor,
                           core: torch.Tensor, eps, pairs, *, bt: int) -> torch.Tensor:
    """``min_label_sweep`` over the active tile pairs of spatially sorted
    points (n a multiple of ``bt``); ``pairs``: an ``ops.TilePairs``.  The
    kernel walks the diagonal tiles and the upper list (``pairs.up_rows``,
    ...) and tests each unordered pair once; bit for bit
    ``ref.min_label_sweep_sparse`` on every input."""
    if _device_kind(x) == "cpu":
        return ref.min_label_sweep_sparse(x, mask, labels, core, eps, pairs.rows,
                                          pairs.cols, pairs.flags, bt)
    n = _check_points(x, (mask, torch.bool), (labels, torch.int32), (core, torch.bool))
    _check_sparse(x, pairs, bt)
    out = torch.full((n,), ref.SENTINEL, dtype=torch.int32, device=x.device)
    if n:
        _launch(x, _sym_lib().min_label_sweep_sparse_launch, "min_label_sweep_sparse",
                x.data_ptr(), mask.data_ptr(), labels.data_ptr(), core.data_ptr(),
                pairs.up_rows.data_ptr(), pairs.up_cols.data_ptr(), pairs.n_up.data_ptr(),
                n, bt, sym_tile(bt), ref.eps_sq_f32(eps), out.data_ptr())
    return out

