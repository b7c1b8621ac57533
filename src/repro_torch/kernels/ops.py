"""Public kernel entry points, dispatched by the device of the tensors.

A CUDA tensor goes to the hand-written CUDA kernel, a CPU tensor to the
plain version in ``ref``.  Nothing probes for a GPU: where a tensor lies
decides.  The kernels mask the ragged edge themselves, so nothing is
padded here.

``FORCE = "ref"`` sends every op to the plain version whatever the
device (the tests and the comparison phase of ``chip_smoke.py`` use it
to run the same path without the kernels on the card).
"""
from __future__ import annotations

import torch

from . import contour_dist as _cd
from . import pairwise_dist as _pd
from . import ref

FORCE: str | None = None


def use_gpu_kernels(t: torch.Tensor) -> bool:
    """Would an op on ``t`` launch a CUDA kernel right now?"""
    return FORCE != "ref" and t.device.type == "cuda"


def neighbor_count(x: torch.Tensor, mask: torch.Tensor, eps) -> torch.Tensor:
    if FORCE == "ref":
        return ref.neighbor_count(x, mask, eps)
    return _pd.neighbor_count(x, mask, eps)


def min_label_sweep(x, mask, labels, core, eps) -> torch.Tensor:
    if FORCE == "ref":
        return ref.min_label_sweep(x, mask, labels, core, eps)
    return _pd.min_label_sweep(x, mask, labels, core, eps)


def contour_min_d2(contours: torch.Tensor, counts: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """(m, m) min squared distance between padded contour buffers (1e30
    where either side is empty).  contours: (m, v, 2); counts: (m,);
    valid: (m,) bool.  The kernel uses the difference form directly, so
    unlike the TPU path nothing is centred."""
    if FORCE == "ref":
        return ref.contour_min_d2(contours, counts, valid)
    return _cd.contour_min_d2(contours, counts, valid)


def launch_counts() -> dict[str, int]:
    return {**_pd.launches, **_cd.launches}


def reset_launch_counts() -> None:
    for d in (_pd.launches, _cd.launches):
        for k in d:
            d[k] = 0
