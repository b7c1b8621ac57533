"""Phase-2 merge-matrix kernel: slot×slot min squared contour distance,
square (the merge matrix) and rectangular (the delta merge's dirty rows)
(CUDA source: ``csrc/contour_dist.cu``).

Counterpart of the Pallas kernel ``repro/kernels/contour_dist.py::
contour_min_d2`` and, in its rectangular form, of the reference's jnp
``repro/core/ddc.py::cross_min_d2``, in the difference form
fma(dy, dy, dx·dx) that XLA:CPU compiles the jitted reference to, so no
centring is needed.  Only the valid slots are tested, each unordered pair
of them once in the square form.  Square batches whose slot lists do not
fit a block's shared memory (a 512-lane fold) take the staged entry,
which first compacts the lists into a scratch buffer by a kernel launch
of its own; a rectangular batch that large raises.  A CUDA tensor
launches the kernel on the current stream; a CPU tensor runs
``ref.contour_min_d2`` / ``ref.cross_min_d2``; any other device raises.
``launches`` counts the main kernel's launches and nothing else;
``compact_launches`` counts the staged entry's compaction launches
(zeroed by ``ops.reset_launch_counts``, outside ``ops.launch_counts()``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

MAX_SHARED = 227 * 1024  # bytes of shared memory one block may use (sm_90)
WARPS = 8                # warps per block (contour_dist.cu kThreads / 32)

launches = {"contour_min_d2": 0, "cross_min_d2": 0}
compact_launches = {"contour_min_d2": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("contour_dist")
    lib.contour_min_d2_launch.argtypes = [_P, _P, _P, _I, _I, _P, _P]
    lib.contour_min_d2_launch.restype = _I
    lib.cross_min_d2_launch.argtypes = [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P]
    lib.cross_min_d2_launch.restype = _I
    lib.contour_min_d2_staged_launch.argtypes = [_P, _P, _P, _I, _I, _P, _P, _P]
    lib.contour_min_d2_staged_launch.restype = _I
    lib.contour_dist_error_string.argtypes = [_I]
    lib.contour_dist_error_string.restype = ctypes.c_char_p
    return lib


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _check_side(contours: torch.Tensor, counts: torch.Tensor, valid: torch.Tensor,
                dev: torch.device) -> tuple[int, int]:
    if contours.dtype != torch.float32 or contours.dim() != 3 or contours.shape[2] != 2:
        raise ValueError(f"contours must be (m, v, 2) float32, got "
                         f"{tuple(contours.shape)} {contours.dtype}")
    m, v, _ = contours.shape
    for t, dtype in ((contours, torch.float32), (counts, torch.int32), (valid, torch.bool)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"expected contiguous {dtype} on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if counts.shape != (m,) or valid.shape != (m,):
        raise ValueError(f"counts/valid must be ({m},)")
    if v < 1 or m * v >= 2**31:
        raise ValueError(f"v = {v}, m = {m} exceed the kernel's limits")
    return m, v


def _check_shared(v: int, slots: int) -> None:
    """The kernel's shared memory: v row vertices, the block min, and a
    count and a list entry per slot of both sides."""
    if v * 8 + 2 * WARPS * 4 + slots * 8 > MAX_SHARED:
        raise ValueError(f"v = {v} with {slots} slots exceeds the kernel's shared memory")


def _staged(v: int, m: int, dev: torch.device) -> torch.Tensor | None:
    """None when the square form's m slot lists fit shared memory, else
    the staged entry's scratch buffer: m counts, m list entries and the
    list's length (v row vertices must fit all the same)."""
    _check_shared(v, 0)
    if v * 8 + 2 * WARPS * 4 + m * 8 <= MAX_SHARED:
        return None
    return torch.empty(2 * m + 1, dtype=torch.int32, device=dev)


def _launch(name: str, fn, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        code = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        msg = _lib().contour_dist_error_string(code).decode()
        raise _build.KernelLaunchError(f"{name}: CUDA error {code} ({msg})")
    launches[name] += 1


def contour_min_d2(contours: torch.Tensor, counts: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """(m, m) min squared distance between padded contour buffers, BIG
    where either slot has no valid vertex.  contours: (m, v, 2) f32;
    counts: (m,) i32; valid: (m,) bool.  Bit for bit ``cross_min_d2`` of
    the buffers with themselves."""
    if _device_kind(contours) == "cpu":
        return ref.contour_min_d2(contours, counts, valid)
    m, v = _check_side(contours, counts, valid, contours.device)
    staged = _staged(v, m, contours.device)
    out = torch.empty((m, m), dtype=torch.float32, device=contours.device)
    args = (contours.data_ptr(), counts.data_ptr(), valid.data_ptr(), m, v, out.data_ptr())
    if staged is None:
        _launch("contour_min_d2", _lib().contour_min_d2_launch, contours.device, *args)
    else:
        _launch("contour_min_d2", _lib().contour_min_d2_staged_launch, contours.device,
                *args, staged.data_ptr())
        compact_launches["contour_min_d2"] += 1
    return out


def cross_min_d2(ca: torch.Tensor, cnta: torch.Tensor, va: torch.Tensor,
                 cb: torch.Tensor, cntb: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """(A, B) min squared distance between two padded contour buffers
    (A, v, 2) × (B, v, 2), BIG where either slot has no valid vertex; a
    row equals the square form's row of the same slot bit for bit.  Raises
    when the slot lists of both sides do not fit a block's shared memory
    (no path gives it that many slots)."""
    if _device_kind(ca) == "cpu":
        return ref.cross_min_d2(ca, cnta, va, cb, cntb, vb)
    a, v = _check_side(ca, cnta, va, ca.device)
    b, v_b = _check_side(cb, cntb, vb, ca.device)
    if v_b != v:
        raise ValueError(f"both sides need the same v, got {v} and {v_b}")
    _check_shared(v, a + b)
    out = torch.empty((a, b), dtype=torch.float32, device=ca.device)
    _launch("cross_min_d2", _lib().cross_min_d2_launch, ca.device,
            ca.data_ptr(), cnta.data_ptr(), va.data_ptr(), a,
            cb.data_ptr(), cntb.data_ptr(), vb.data_ptr(), b, v, out.data_ptr())
    return out
