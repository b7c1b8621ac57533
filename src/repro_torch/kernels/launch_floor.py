"""The launch floor: an empty kernel (one block, no work; CUDA source
``csrc/launch_floor.cu``), built and launched through the same nvcc and
ctypes route as every kernel of the port.  Its device time per call is
the least any kernel launch takes on the card; no path launches it."""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build


@functools.cache
def _lib():
    lib = _build.load("launch_floor")
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    return lib


def empty(device) -> None:
    """Launch the empty kernel on ``device``'s current stream; raises
    ``ValueError`` for a device that is not CUDA."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the empty kernel runs on a CUDA device, not {device}")
    with torch.cuda.device(device):
        code = _lib().empty_launch(torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise _build.KernelLaunchError(f"empty kernel: CUDA error {code}")
