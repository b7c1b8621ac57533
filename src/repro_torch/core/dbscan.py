"""DBSCAN — the paper's local clustering algorithm, in two forms.

* ``dbscan_ref`` — classic BFS DBSCAN in NumPy (the oracle).
* ``dbscan`` — the device version: ε-neighbour counts and min-label
  propagation sweeps run in the fused kernels of
  ``kernels/pairwise_dist``, and labels converge by fixed-point
  iteration in a host loop, with pointer-doubling shortcut steps after
  every sweep so convergence takes O(log n) sweeps.

``dbscan`` has two paths, bit-identical to each other and to the
reference's:

* **dense** — every point pair is tested;
* **block-sparse** (``block_sparse``) — points are sorted by Morton code
  so ε-neighbours land in nearby tiles, per-tile bounding boxes prune
  the tile pairs that are provably farther than ε apart, and the sweeps
  run the sparse kernels over the active pairs only (the dense kernels
  on the sorted points when more than ``dense_fallback_frac`` of the
  pairs are active).  Labels come back in caller order.

Semantics (both): a point is *core* iff its ε-neighbourhood (self
included) has >= min_pts points.  Core points within ε of each other
share a cluster; border points adopt the smallest neighbouring core
label; everything else is noise (-1).  Labels are the smallest point
index of each cluster's core set, so all forms agree exactly.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import partitioner
from repro_torch.kernels import ops

NOISE = -1
SENTINEL = 2**30

# Dense fallback of the block-sparse path: when more than this fraction of
# tile pairs is active, the sweeps use the dense kernels on the sorted
# points instead (same math, same results).
DENSE_FALLBACK_FRAC = 0.5


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


def spatial_sort(points: torch.Tensor, mask: torch.Tensor, bt: int):
    """Block-sparse preamble: pad to a ``bt`` multiple and Morton-sort.

    Bounds of the Morton grid come from masked points only, and masked or
    padding rows get code 2**30, so they sort to the tail tiles.  The sort
    is stable, as the reference's, so tied codes keep their order.
    Returns (sorted_points, sorted_mask, order (npad,) int64)."""
    n = points.shape[0]
    pad = (-n) % bt
    pp = torch.cat([points.to(torch.float32), points.new_zeros((pad, 2), dtype=torch.float32)])
    mm = torch.cat([mask, mask.new_zeros(pad)])
    lo = torch.where(mm[:, None], pp, 3.4e38).amin(dim=0)
    hi = torch.where(mm[:, None], pp, -3.4e38).amax(dim=0)
    code = partitioner.morton_code(pp, bounds=(lo[0], lo[1], hi[0], hi[1]))
    code = torch.where(mm, code, SENTINEL)
    order = torch.argsort(code, stable=True)
    return pp[order], mm[order], order


def _use_block_sparse(block_sparse: str, points: torch.Tensor, bt: int) -> bool:
    if block_sparse not in ("never", "auto", "always"):
        raise ValueError(f"block_sparse must be never|auto|always, got {block_sparse!r}")
    # "auto" takes the sparse path with the GPU kernels and at least two
    # tiles of points, exactly where the reference takes it with its
    # kernels, so that each package's plain run takes the other's path.
    return block_sparse == "always" or (
        block_sparse == "auto" and points.shape[0] >= 2 * bt
        and ops.use_gpu_kernels(points))


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
    dense_fallback_frac: float = DENSE_FALLBACK_FRAC,
) -> DBSCANResult:
    """DBSCAN on a padded point buffer.

    points: (n, 2) float32; mask: (n,) bool (padding excluded everywhere),
    both on the device the work runs on.  Label propagation:
    L_i <- min(L_i, min_{j in N(i) ∩ core} L_j) for core i, iterated to a
    fixed point with ``ceil(log2 n)`` pointer-doubling steps after each
    sweep.

    ``block_sparse``: "never" | "auto" | "always".  "always" takes the
    block-sparse path on any device; "auto" takes it for n >= 2·``bt``
    when the ops launch GPU kernels.  ``bt`` is its tile size;
    ``dense_fallback_frac`` its dense fallback threshold.
    """
    return dbscan_traced(points, mask, eps, min_pts, max_iters, block_sparse=block_sparse,
                         bt=bt, pointer_doubling=pointer_doubling,
                         dense_fallback_frac=dense_fallback_frac)[0]


def dbscan_traced(points: torch.Tensor, mask: torch.Tensor, eps: float, min_pts: int,
                  max_iters: int = 512, *, block_sparse: str = "auto", bt: int = 512,
                  pointer_doubling: bool = True,
                  dense_fallback_frac: float = DENSE_FALLBACK_FRAC):
    """``dbscan`` that also says which path ran: returns (DBSCANResult,
    {"path": "dense" | "sparse" | "dense_fallback", "n_active": int or
    None, "frac": float or None}) — the last two from the tile-pair list
    of the block-sparse path."""
    sparse = _use_block_sparse(block_sparse, points, bt)
    n = points.shape[0]
    points = center_points(points.to(torch.float32), mask).contiguous()
    mask = mask.contiguous()
    doubling_steps = max(1, math.ceil(math.log2(max(n, 2)))) if pointer_doubling else 0
    if sparse:
        return _dbscan_block_sparse(points, mask, eps, min_pts, max_iters, bt=bt,
                                    doubling_steps=doubling_steps,
                                    dense_fallback_frac=dense_fallback_frac)
    idx = torch.arange(n, dtype=torch.int32, device=points.device)
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
    path = {"path": "dense", "n_active": None, "frac": None}
    return _result(labels, core, idx, n_sweeps), path


def _result(labels, core, idx, n_sweeps: int) -> DBSCANResult:
    """Count the clusters (core points that are their own label) and mark
    noise; labels and core in caller order."""
    n_clusters = (core & (labels == idx)).sum(dtype=torch.int32)
    labels = torch.where(labels == SENTINEL, NOISE, labels)
    return DBSCANResult(labels, core, n_clusters,
                        torch.tensor(n_sweeps, dtype=torch.int32, device=labels.device))


def _dbscan_block_sparse(points, mask, eps, min_pts: int, max_iters: int, *, bt: int,
                         doubling_steps: int, dense_fallback_frac: float):
    """Morton sort → bbox tile pruning → sparse sweeps → canonicalise →
    inverse permutation, on centred points.  The dense fallback is decided
    once, on the host, from the active fraction."""
    n = points.shape[0]
    sp, sm, order = spatial_sort(points, mask, bt)
    npad = sp.shape[0]
    pairs = ops.build_tile_pairs(sp, sm, eps, bt=bt)
    frac = float(pairs.frac)
    # Compared in float32, as the reference compares its float32 frac.
    use_sparse = frac <= float(np.float32(dense_fallback_frac))
    if use_sparse:
        counts = ops.neighbor_count_sparse(sp, sm, eps, pairs, bt=bt)
        sweep = lambda l, c: ops.min_label_sweep_sparse(sp, sm, l, c, eps, pairs, bt=bt)
    else:
        counts = ops.neighbor_count(sp, sm, eps)
        sweep = lambda l, c: ops.min_label_sweep(sp, sm, l, c, eps)
    core = (counts >= min_pts) & sm
    sidx = torch.arange(npad, dtype=torch.int32, device=sp.device)
    init = torch.where(core, sidx, SENTINEL)
    labels, n_sweeps = _propagate(lambda l: sweep(l, core), init, core, max_iters,
                                  doubling_steps)

    # Canonicalise: converged labels hold the min *sorted* index of each
    # cluster; remap every cluster to its min ORIGINAL index so labels (and
    # the border tie-break below) match the dense path bit for bit.  Core
    # labels are sorted indices < npad, so every root index is in range.
    orig = order.to(torch.int32)
    root = torch.where(core, labels, 0).long()
    min_orig = torch.full((npad,), SENTINEL, dtype=torch.int32, device=sp.device)
    min_orig.scatter_reduce_(0, root, torch.where(core, orig, SENTINEL), "amin",
                             include_self=True)
    canon = torch.where(core, min_orig[root], SENTINEL)

    # Border points: min canonical core-neighbour label.
    swept = sweep(canon, core)
    labels_s = torch.where(core, canon, swept)
    labels_s = torch.where(sm & (labels_s < SENTINEL), labels_s, SENTINEL)

    # Inverse permutation (order is a permutation of npad): caller order.
    labels = torch.empty_like(labels_s)
    labels[order] = labels_s
    core_o = torch.empty_like(core)
    core_o[order] = core
    idx = torch.arange(n, dtype=torch.int32, device=sp.device)
    path = {"path": "sparse" if use_sparse else "dense_fallback",
            "n_active": int(pairs.n_active), "frac": frac}
    return _result(labels[:n], core_o[:n], idx, n_sweeps), path


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
