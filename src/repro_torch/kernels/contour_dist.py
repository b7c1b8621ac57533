"""Phase-2 merge-matrix kernel: slot×slot min squared contour distance
(CUDA source: ``csrc/contour_dist.cu``).

Counterpart of the Pallas kernel ``repro/kernels/contour_dist.py::
contour_min_d2``, in the difference form of the plain version, so no
centring is needed.  A CUDA tensor launches the kernel on the current
stream; a CPU tensor runs ``ref.contour_min_d2``; any other device
raises.  ``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

MAX_SHARED = 227 * 1024  # bytes of shared memory one block may use (sm_90)

launches = {"contour_min_d2": 0}

_P = ctypes.c_void_p


@functools.cache
def _lib():
    lib = _build.load("contour_dist")
    lib.contour_min_d2_launch.argtypes = [
        _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P]
    lib.contour_min_d2_launch.restype = ctypes.c_int
    lib.contour_dist_error_string.argtypes = [ctypes.c_int]
    lib.contour_dist_error_string.restype = ctypes.c_char_p
    return lib


def contour_min_d2(contours: torch.Tensor, counts: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """(m, m) min squared distance between padded contour buffers, BIG
    where either slot has no valid vertex.  contours: (m, v, 2) f32;
    counts: (m,) i32; valid: (m,) bool."""
    if contours.device.type == "cpu":
        return ref.contour_min_d2(contours, counts, valid)
    if contours.device.type != "cuda":
        raise ValueError(f"unsupported device {contours.device}")
    if contours.dtype != torch.float32 or contours.dim() != 3 or contours.shape[2] != 2:
        raise ValueError(f"contours must be (m, v, 2) float32, got "
                         f"{tuple(contours.shape)} {contours.dtype}")
    m, v, _ = contours.shape
    for t, dtype in ((contours, torch.float32), (counts, torch.int32), (valid, torch.bool)):
        if t.device != contours.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"expected contiguous {dtype} on {contours.device}, "
                             f"got {t.dtype} on {t.device}")
    if counts.shape != (m,) or valid.shape != (m,):
        raise ValueError(f"counts/valid must be ({m},)")
    if v * 8 + 4 * 1024 > MAX_SHARED or m * v >= 2**31:
        raise ValueError(f"v = {v}, m = {m} exceed the kernel's limits")
    out = torch.empty((m, m), dtype=torch.float32, device=contours.device)
    lib = _lib()
    with torch.cuda.device(contours.device):
        code = lib.contour_min_d2_launch(
            contours.data_ptr(), counts.data_ptr(), valid.data_ptr(), m, v,
            out.data_ptr(), torch.cuda.current_stream(contours.device).cuda_stream)
    if code != 0:
        msg = lib.contour_dist_error_string(code).decode()
        raise _build.KernelLaunchError(f"contour_min_d2: CUDA error {code} ({msg})")
    launches["contour_min_d2"] += 1
    return out
