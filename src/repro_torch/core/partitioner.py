"""Data partitioning for DDC phase 1: the Morton (Z-order) code as a
torch op, on the points' own device, and the shard splits, including the
paper's capacity-aware split (Experiment IV), which doubles as the
straggler-mitigation policy: slow hosts get smaller shards so all shards
finish phase 1 together.

Counterpart of ``repro/core/partitioner.py``; the block-sparse DBSCAN
path sorts by ``morton_code`` so that ε-neighbours land in nearby tiles.
(``repro_torch/data/spatial.py`` keeps a NumPy copy for the data
generators.)  The splits and sizes are NumPy, as in the reference.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
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


def split_block(n: int, k: int) -> list[np.ndarray]:
    return np.array_split(np.arange(n), k)


def split_random(n: int, k: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return np.array_split(perm, k)


def split_spatial(points: np.ndarray, k: int) -> list[np.ndarray]:
    """Morton-ish spatial split: sort by interleaved grid bits so shards
    are spatially compact (fewer cross-shard clusters to merge)."""
    pts = torch.as_tensor(np.asarray(points, np.float32))
    code = morton_code(pts, bounds=(0.0, 0.0, 1.0, 1.0)).numpy()
    order = np.argsort(code, kind="stable")
    return np.array_split(order, k)


def capacity_aware_sizes(
    n: int, speeds: Sequence[float], complexity_exp: float = 2.0
) -> np.ndarray:
    """Shard sizes that equalise phase-1 time under t_i = n_i^k / s_i.

    Equal time => n_i ∝ s_i^(1/k).  k=2 for DBSCAN (the paper's case).
    """
    s = np.asarray(speeds, np.float64) ** (1.0 / complexity_exp)
    sizes = np.floor(n * s / s.sum()).astype(int)
    sizes[: n - sizes.sum()] += 1
    return sizes


def split_capacity_aware(
    n: int, speeds: Sequence[float], complexity_exp: float = 2.0, seed: int = 0
) -> list[np.ndarray]:
    sizes = capacity_aware_sizes(n, speeds, complexity_exp)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    out, off = [], 0
    for sz in sizes:
        out.append(perm[off : off + sz])
        off += sz
    return out


# --- Paper experiment scenarios (sizes per machine, 8 machines) -----------

def scenario_sizes(which: str, n: int = 10_000, seed: int = 0,
                   speeds: Sequence[float] | None = None) -> list[int]:
    """Shard sizes for the paper's Experiments I–IV (section 5)."""
    if which == "I":     # random chunks in [1500, 10000]; M1 gets the full set
        sizes = [10_000, 2_500, 3_275, 5_000, 1_666, 2_000, 5_000, 1_500]
    elif which == "II":  # one machine the whole dataset, the rest 1/8
        sizes = [n] + [n // 8] * 7
    elif which == "III":  # seven machines the whole dataset, one 1/8
        sizes = [n] * 7 + [n // 8]
    elif which == "IV":  # capacity-aware (paper Table 6 sizes)
        if speeds is None:
            sizes = [1_500, 1_660, 500, 1_000, 1_500, 1_400, 1_000, 1_500]
        else:
            sizes = capacity_aware_sizes(sum([1250] * 8), speeds).tolist()
    else:
        raise ValueError(which)
    return [int(s) for s in sizes]
