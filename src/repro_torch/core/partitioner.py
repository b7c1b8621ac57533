"""Spatial ordering for DDC phase 1: the Morton (Z-order) code as a torch
op, on the points' own device.

Counterpart of ``repro/core/partitioner.py::morton_code``; the block-sparse
DBSCAN path sorts by it so that ε-neighbours land in nearby tiles.
(``repro_torch/data/spatial.py`` keeps a NumPy copy for the data
generators.)
"""
from __future__ import annotations

import torch

MORTON_BITS = 10


def morton_code(points: torch.Tensor, bounds=None, bits: int = MORTON_BITS) -> torch.Tensor:
    """Interleaved grid-bit (Z-order) code per point, (n,) int32.

    points: (n, 2) in data units.  ``bounds`` = (x0, y0, x1, y1), numbers
    or 0-d tensors; when None the points' own bounding box is used.  Every
    step is float32, as in the reference, and the grid cell is clamped to
    [0, 2**bits) before the cast to int32, so a point outside the bounds
    gets the edge cell (the reference's saturating cast, then its clip).
    """
    pts = torch.as_tensor(points).to(torch.float32)
    if bounds is None:
        lo = pts.amin(dim=0)
        hi = pts.amax(dim=0)
    else:
        lo, hi = (torch.stack([torch.as_tensor(b, dtype=torch.float32, device=pts.device)
                               for b in pair]) for pair in (bounds[:2], bounds[2:]))
    g = 1 << bits
    scale = torch.where(hi > lo, hi - lo, 1.0)
    cell = ((pts - lo) / scale * g).nan_to_num(nan=0.0).clamp(0, g - 1).to(torch.int32)
    ix, iy = cell[:, 0], cell[:, 1]
    code = torch.zeros(pts.shape[0], dtype=torch.int32, device=pts.device)
    for b in range(bits):
        code |= ((ix >> b) & 1) << (2 * b + 1)
        code |= ((iy >> b) & 1) << (2 * b)
    return code
