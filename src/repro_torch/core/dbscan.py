"""DBSCAN — the paper's local clustering algorithm, in two forms.

* ``dbscan_ref`` — classic BFS DBSCAN in NumPy (the oracle).
* ``dbscan`` — the dense device version: ε-neighbour counts and
  min-label propagation sweeps run in the fused kernels of
  ``kernels/pairwise_dist``, and labels converge by fixed-point
  iteration in a host loop, with pointer-doubling shortcut steps after
  every sweep so convergence takes O(log n) sweeps.

Semantics (both): a point is *core* iff its ε-neighbourhood (self
included) has >= min_pts points.  Core points within ε of each other
share a cluster; border points adopt the smallest neighbouring core
label; everything else is noise (-1).  Labels are the smallest point
index of each cluster's core set, so the two forms agree exactly.

Only the dense path exists here: the block-sparse path (Morton sort and
active tile-pair kernels) is not ported, and asking for it raises.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops

NOISE = -1
SENTINEL = 2**30


def dbscan_ref(points: np.ndarray, eps: float, min_pts: int) -> np.ndarray:
    """NumPy oracle.  Returns labels (n,) int32, noise = -1, labels are
    the minimum point index of each cluster's core set."""
    pts = np.asarray(points, dtype=np.float64)
    n = len(pts)
    if n == 0:
        return np.zeros((0,), np.int32)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    adj = d2 <= eps * eps
    counts = adj.sum(1)
    core = counts >= min_pts

    labels = np.full(n, SENTINEL, np.int64)
    # Connected components over core points (edges between core pairs).
    for i in range(n):
        if not core[i] or labels[i] != SENTINEL:
            continue
        stack = [i]
        labels[i] = i
        while stack:
            u = stack.pop()
            for v in np.nonzero(adj[u] & core)[0]:
                if labels[v] == SENTINEL:
                    labels[v] = i
                    stack.append(v)
    # Canonicalise: min core index per component.
    for comp in set(labels[core]):
        members = np.nonzero(core & (labels == comp))[0]
        labels[members] = members.min()
    # Border points: min label among core neighbours.
    for i in range(n):
        if core[i]:
            continue
        neigh = np.nonzero(adj[i] & core)[0]
        labels[i] = labels[neigh].min() if len(neigh) else SENTINEL
    labels[labels == SENTINEL] = NOISE
    return labels.astype(np.int32)


class DBSCANResult(NamedTuple):
    labels: torch.Tensor      # (n,) int32; -1 noise, else min core index
    core: torch.Tensor        # (n,) bool
    n_clusters: torch.Tensor  # () int32
    n_sweeps: torch.Tensor    # () int32 — propagation sweeps to convergence


def _shortcut(labels: torch.Tensor, steps: int) -> torch.Tensor:
    """Pointer doubling: ``labels <- min(labels, labels[labels])``,
    ``steps`` times.  For core i, labels[i] is always the index of a core
    point of the same cluster, so the jump stays in-cluster; SENTINEL
    entries (>= n) never jump."""
    n = labels.shape[0]
    for _ in range(steps):
        inside = labels < n
        jumped = labels[torch.where(inside, labels, 0).long()]
        labels = torch.minimum(labels, torch.where(inside, jumped, labels))
    return labels


def _propagate(sweep_fn, init: torch.Tensor, core: torch.Tensor, max_iters: int,
               doubling_steps: int):
    """Iterate min-label sweeps (+ pointer doubling) to a fixed point, or
    ``max_iters`` sweeps.  Returns (labels, n_sweeps)."""
    labels, n_sweeps, changed = init, 0, True
    while changed and n_sweeps < max_iters:
        swept = sweep_fn(labels)
        new = torch.where(core, torch.minimum(labels, swept), labels)
        if doubling_steps:
            new = _shortcut(new, doubling_steps)
        changed = bool((new != labels).any())
        labels, n_sweeps = new, n_sweeps + 1
    return labels, n_sweeps


def center_points(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Centre masked points on their bbox midpoint and zero masked rows —
    the coordinates every phase-1 kernel sees.  d2 is translation
    invariant, but the kernels' xx+yy−2xy expansion loses accuracy with
    the coordinates' magnitude."""
    big = torch.tensor(3.4e38, dtype=torch.float32, device=points.device)
    m = mask[:, None]
    lo = torch.where(m, points, big).amin(dim=0)
    hi = torch.where(m, points, -big).amax(dim=0)
    center = torch.where(hi >= lo, (lo + hi) * 0.5, 0.0)
    return torch.where(m, points - center, 0.0)


def _check_block_sparse(block_sparse: str, points: torch.Tensor, bt: int) -> None:
    if block_sparse not in ("never", "auto", "always"):
        raise ValueError(f"block_sparse must be never|auto|always, got {block_sparse!r}")
    # "auto" takes the sparse path with a kernel backend and at least two
    # tiles of points, exactly where the reference takes it; off the GPU
    # it is the dense path.
    sparse = block_sparse == "always" or (
        block_sparse == "auto" and points.shape[0] >= 2 * bt
        and ops.use_gpu_kernels(points))
    if sparse:
        raise NotImplementedError(
            "block-sparse DBSCAN is not ported yet: it needs the "
            "neighbor_count_sparse and min_label_sweep_sparse kernels and "
            "spatial_sort/build_tile_pairs; pass block_sparse='never'")


def dbscan(
    points: torch.Tensor,
    mask: torch.Tensor,
    eps: float,
    min_pts: int,
    max_iters: int = 512,
    *,
    block_sparse: str = "auto",
    bt: int = 512,
    pointer_doubling: bool = True,
) -> DBSCANResult:
    """Dense DBSCAN on a padded point buffer.

    points: (n, 2) float32; mask: (n,) bool (padding excluded everywhere),
    both on the device the work runs on.  Label propagation:
    L_i <- min(L_i, min_{j in N(i) ∩ core} L_j) for core i, iterated to a
    fixed point with ``ceil(log2 n)`` pointer-doubling steps after each
    sweep.  ``block_sparse`` is accepted for the reference's signature;
    see ``_check_block_sparse``.
    """
    _check_block_sparse(block_sparse, points, bt)
    points = points.to(torch.float32)
    n = points.shape[0]
    dev = points.device
    points = center_points(points, mask).contiguous()
    mask = mask.contiguous()
    doubling_steps = max(1, math.ceil(math.log2(max(n, 2)))) if pointer_doubling else 0
    idx = torch.arange(n, dtype=torch.int32, device=dev)

    counts = ops.neighbor_count(points, mask, eps)
    core = (counts >= min_pts) & mask
    init = torch.where(core, idx, SENTINEL)
    labels, n_sweeps = _propagate(
        lambda l: ops.min_label_sweep(points, mask, l, core, eps),
        init, core, max_iters, doubling_steps,
    )

    # Border points: min core-neighbour label (non-core, in-mask).
    swept = ops.min_label_sweep(points, mask, labels, core, eps)
    labels = torch.where(core, labels, swept)
    labels = torch.where(mask & (labels < SENTINEL), labels, SENTINEL)

    # Clusters: core points that are their own label.
    is_root = core & (labels == idx)
    n_clusters = is_root.sum(dtype=torch.int32)
    labels = torch.where(labels == SENTINEL, NOISE, labels)
    return DBSCANResult(labels, core, n_clusters,
                        torch.tensor(n_sweeps, dtype=torch.int32, device=dev))


def relabel_dense(labels: torch.Tensor, max_clusters: int) -> torch.Tensor:
    """Map min-index labels to dense ids [0, max_clusters) by cluster-root
    order; -1 stays -1, clusters beyond the budget map to -1."""
    n = labels.shape[0]
    is_root = labels == torch.arange(n, dtype=labels.dtype, device=labels.device)
    root_rank = torch.cumsum(is_root.to(torch.int32), 0, dtype=torch.int32) - 1
    dense_at_root = torch.where(is_root, root_rank, 0)
    safe = labels.clamp(0, max(n - 1, 0)).long()
    dense = dense_at_root[safe]
    dense = torch.where(labels == NOISE, NOISE, dense)
    dense = torch.where(dense >= max_clusters, NOISE, dense)
    return dense.to(torch.int32)
