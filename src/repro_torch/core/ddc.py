"""Dynamic Distributed Clustering (DDC) — the paper's contribution, on one
device.

Phase 1 (per shard, zero communication): every shard clusters its local
points with DBSCAN or K-Means and reduces each cluster to a fixed-size
contour buffer.  Phase 2: the shards' contours merge by contour
proximity into global clusters.  A merge folds a stacked batch of
ClusterSets (``merge_many``): the slot×slot min-distance matrix comes
from one kernel call, the overlap graph's components from pointer-doubled
label propagation, and merged contours are re-extracted on the global
raster (or subsampled, ``merge_refine="fps"``).  The delta merge
(``merge_delta``) patches a cached matrix in the dirty shards' rows and
columns (``update_pair_d2``, ``update_pair_d2_many``, on the kernel's
rectangular form ``cross_min_d2``) and gives the rebuild's result bit for
bit.

``make_ddc_fn`` is the one-device form of the reference's distributed
entry point: the K shard lanes run one after another on one device, and
the phase-2 schedules (``merge_sync``, ``merge_async``, ``merge_tree``)
fold the lanes' ClusterSets exactly as the reference's collectives would
deliver them, giving every lane the map its reference lane computes.  A
``CommMeter`` counts what the reference's collectives would move.

``ddc_shard`` is the reference's distributed form: one shard on each rank
of a ``torch.distributed`` group (``launch/ranks.py`` starts the ranks),
phase 1 on the rank's device and phase 2 as real collectives over the
group (``merge_sync_shard``, ``merge_async_shard``, ``merge_tree_shard``),
only ClusterSets crossing between ranks (``Wire``).  Both forms give the
same bits.

Host path: ``ddc_host`` (NumPy, exact polygon-overlap merge) is the
paper-faithful oracle.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import dbscan as dbscan_mod
from repro_torch.core import geometry
from repro_torch.core import kmeans as kmeans_mod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import fma_f32
from repro_torch.parallel import compress

LOCAL_ALGOS = ("dbscan", "kmeans")
SCHEDULES = ("sync", "async", "tree")
MERGE_REFINES = ("grid", "fps")

SENTINEL = 2**30


@dataclasses.dataclass(frozen=True)
class DDCConfig:
    """Static configuration of the DDC pipeline; the same fields and
    defaults as the reference package's ``DDCConfig``."""

    eps: float = 0.05                  # DBSCAN radius (data units)
    min_pts: int = 5
    bounds: Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)
    grid: int = 128                    # contour raster resolution
    max_clusters: int = 32             # C: per-shard cluster budget
    max_verts: int = 128               # V: per-cluster contour budget
    merge_eps: float | None = None     # contour-overlap distance; default eps
    local_algo: str = "dbscan"         # "dbscan" | "kmeans"
    kmeans_k: int = 8
    schedule: str = "async"            # "sync" | "async" | "tree"
    tree_degree: int = 2               # D for the paper's Algorithm-2 tree
    merge_refine: str = "grid"         # "grid" | "fps"
    block_sparse: str = "auto"         # phase-1 spatial pruning (dbscan.py)
    block_tile: int = 512              # tile size for the block-sparse path

    @property
    def merge_radius(self) -> float:
        # Contours are grid-cell centres; two touching clusters' boundary
        # cells are within one cell diagonal + eps of each other.
        cell = max(
            (self.bounds[2] - self.bounds[0]) / self.grid,
            (self.bounds[3] - self.bounds[1]) / self.grid,
        )
        base = self.merge_eps if self.merge_eps is not None else self.eps
        return base + 1.5 * cell

    def buffer_bytes(self) -> int:
        """Bytes a ClusterSet occupies on the wire (the 1–2 % claim)."""
        c, v = self.max_clusters, self.max_verts
        return c * v * 2 * 4 + c * 4 + c * 4 + c * 1 + 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DDCConfig":
        """Build from ``dataclasses.asdict`` of either package's config."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown DDCConfig fields: {sorted(unknown)}")
        d = dict(d)
        if "bounds" in d:
            d["bounds"] = tuple(float(b) for b in d["bounds"])
        return cls(**d)


class ClusterSet(NamedTuple):
    """Fixed-size representation of a shard's clusters."""

    contours: torch.Tensor  # (C, V, 2) f32 — padded contour vertices
    counts: torch.Tensor    # (C,)     i32 — valid vertices per cluster
    sizes: torch.Tensor     # (C,)     i32 — member-point counts
    valid: torch.Tensor     # (C,)     bool
    overflow: torch.Tensor  # ()       bool — cluster budget exceeded somewhere


_CS_DTYPES = (torch.float32, torch.int32, torch.int32, torch.bool, torch.bool)


def empty_clusterset(cfg: DDCConfig, device="cuda") -> ClusterSet:
    """The all-invalid ClusterSet for ``cfg``'s budgets."""
    c, v = cfg.max_clusters, cfg.max_verts
    return ClusterSet(
        contours=torch.zeros((c, v, 2), dtype=torch.float32, device=device),
        counts=torch.zeros((c,), dtype=torch.int32, device=device),
        sizes=torch.zeros((c,), dtype=torch.int32, device=device),
        valid=torch.zeros((c,), dtype=torch.bool, device=device),
        overflow=torch.tensor(False, device=device),
    )


def stack_clustersets(sets) -> ClusterSet:
    """Stack ClusterSets along a new leading axis (the all-gathered batch)."""
    return ClusterSet(*(torch.stack(leaves) for leaves in zip(*sets)))


def clusterset_from_numpy(arrays, device="cuda") -> ClusterSet:
    """A ClusterSet (or stacked batch) from NumPy arrays: a ClusterSet-like
    tuple in field order, or a mapping by field name — e.g. the reference
    package's ClusterSet converted leaf by leaf with ``np.asarray``."""
    if isinstance(arrays, dict):
        arrays = [arrays[f] for f in ClusterSet._fields]
    return ClusterSet(*(torch.tensor(np.asarray(a), device=device).to(dt)
                        for a, dt in zip(arrays, _CS_DTYPES, strict=True)))


def clusterset_to_numpy(cs: ClusterSet) -> ClusterSet:
    return ClusterSet(*(t.detach().cpu().numpy() for t in cs))


def host_copy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a NumPy array that shares no memory with it (on the CPU
    a bare ``.numpy()`` aliases a tensor that a later in-place write
    changes)."""
    return t.detach().to("cpu", copy=True).numpy()


def _check_cfg(cfg: DDCConfig) -> None:
    for field, allowed in (("local_algo", LOCAL_ALGOS), ("schedule", SCHEDULES),
                           ("merge_refine", MERGE_REFINES)):
        if getattr(cfg, field) not in allowed:
            raise ValueError(f"{field}={getattr(cfg, field)!r}: expected one of {allowed}")
    if cfg.schedule == "tree" and cfg.tree_degree < 2:
        raise ValueError(f"tree_degree must be >= 2, got {cfg.tree_degree}")


# ---------------------------------------------------------------------------
# Phase 1 — local clustering + contour reduction
# ---------------------------------------------------------------------------


def _local_phase(points: torch.Tensor, mask: torch.Tensor, cfg: DDCConfig, seed: int = 0,
                 init: torch.Tensor | None = None):
    """``local_phase`` that also returns the shard's DBSCANResult or
    KMeansResult and its path: the DBSCAN path (``dbscan_traced``), or
    ``{"path": "kmeans"}``."""
    _check_cfg(cfg)
    c = cfg.max_clusters
    dev = points.device
    points = points.to(torch.float32)
    if cfg.local_algo == "dbscan":
        res, path = dbscan_mod.dbscan_traced(points, mask, cfg.eps, cfg.min_pts,
                                             block_sparse=cfg.block_sparse,
                                             bt=cfg.block_tile)
        dense = dbscan_mod.relabel_dense(res.labels, c)
        overflow = res.n_clusters > c
    else:
        generator = None if init is not None else \
            torch.Generator(device=dev).manual_seed(seed)
        res = kmeans_mod.kmeans(points, mask, min(cfg.kmeans_k, c), init=init,
                                generator=generator)
        path = {"path": "kmeans"}
        dense = res.labels
        # min(kmeans_k, C) clusters never exceed the budget C.
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
    sizes = torch.zeros((c,), dtype=torch.int32, device=dev)
    sizes.index_add_(0, dense.clamp(min=0).long(), (dense >= 0).to(torch.int32))
    valid = sizes > 0
    slot = torch.arange(c, dtype=torch.int32, device=dev)
    members = mask[None, :] & (dense[None, :] == slot[:, None])          # (C, n)
    contours, counts = geometry.extract_contour(
        points, members, cfg.bounds, cfg.grid, cfg.max_verts)
    cs = ClusterSet(
        contours=contours,
        counts=torch.where(valid, counts, 0),
        sizes=sizes,
        valid=valid,
        overflow=overflow,
    )
    return res, dense, cs, path


def local_phase(points: torch.Tensor, mask: torch.Tensor, cfg: DDCConfig, *,
                seed: int = 0, init: torch.Tensor | None = None
                ) -> Tuple[torch.Tensor, ClusterSet]:
    """Cluster a shard's points and reduce them to contours, on the
    device the tensors lie on.  Returns (dense local labels (n,) i32,
    ClusterSet).  Zero communication.

    With ``local_algo="kmeans"``, ``seed`` seeds the k-means++ draw (a
    ``torch.Generator`` on the points' device, the counterpart of the
    reference's ``key``, whose default is ``PRNGKey(0)``), or ``init``
    ((k, 2), k = min(kmeans_k, max_clusters)) gives the initial centres."""
    _, dense, cs, _ = _local_phase(points, mask, cfg, seed, init)
    return dense, cs


# ---------------------------------------------------------------------------
# Phase 2 — batched ClusterSet merge
# ---------------------------------------------------------------------------


def _components(overlap: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Min-label connected components over an (M, M) overlap graph: one
    neighbour-min sweep then ``ceil(log2 M)`` pointer-doubling steps per
    iteration, until a sweep changes nothing."""
    m = overlap.shape[0]
    idx = torch.arange(m, dtype=torch.int32, device=overlap.device)
    labels = torch.where(valid, idx, SENTINEL)
    n_shortcut = max(1, (m - 1).bit_length())
    while True:
        neigh = torch.where(overlap, labels[None, :], SENTINEL)
        new = torch.minimum(labels, neigh.amin(dim=1))
        new = torch.where(valid, new, SENTINEL)
        for _ in range(n_shortcut):
            jump = new[new.clamp(0, m - 1).long()]
            new = torch.where(valid, torch.minimum(new, jump), new)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            return labels


def _flat_slots(batch: ClusterSet, cfg: DDCConfig):
    m = batch.valid.shape[0] * cfg.max_clusters
    return (batch.contours.reshape(m, cfg.max_verts, 2), batch.counts.reshape(m),
            batch.valid.reshape(m))


def contour_pair_d2(batch: ClusterSet, cfg: DDCConfig) -> torch.Tensor:
    """The (K·C, K·C) slot×slot min-contour-distance matrix of a stacked
    batch — one kernel call (``ops.contour_min_d2``)."""
    contours, counts, valid = _flat_slots(batch, cfg)
    return ops.contour_min_d2(contours.contiguous(), counts.contiguous(),
                              valid.contiguous())


def cross_min_d2(ca: torch.Tensor, cnta: torch.Tensor, va: torch.Tensor,
                 cb: torch.Tensor, cntb: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """Rectangular min squared distance between two padded contour
    buffers: (A, V, 2) × (B, V, 2) → (A, B), 1e30 where either slot is
    empty — one kernel call (``ops.cross_min_d2``).  A row is bit for bit
    the same slot's row of ``contour_pair_d2``: the delta merge's exactness
    rests on it (DESIGN.md §8)."""
    return ops.cross_min_d2(ca.contiguous(), cnta.contiguous(), va.contiguous(),
                            cb.contiguous(), cntb.contiguous(), vb.contiguous())


def contour_pair_d2_exact(batch: ClusterSet, cfg: DDCConfig) -> torch.Tensor:
    """``contour_pair_d2`` through the rectangular form (``cross_min_d2``
    of the batch with itself), kept for the reference's API.  The two
    forms compute one expression, so they are bit-identical; the square
    one tests each unordered pair once and is the faster rebuild."""
    contours, counts, valid = _flat_slots(batch, cfg)
    return cross_min_d2(contours, counts, valid, contours, counts, valid)


def update_pair_d2(pair_d2: torch.Tensor, batch: ClusterSet, shard: int,
                   cfg: DDCConfig) -> torch.Tensor:
    """Refresh one shard's rows and columns of a cached slot×slot matrix
    after that shard's ClusterSet changed: O(C·M·V²) work instead of the
    full rebuild.  d2 is symmetric bit for bit, so the fresh rows mirrored
    into the columns leave the matrix equal to a rebuild.  Updates
    ``pair_d2`` in place (the reference donates it) and returns it."""
    c = cfg.max_clusters
    contours, counts, valid = _flat_slots(batch, cfg)
    row0 = int(shard) * c
    rows = cross_min_d2(contours[row0:row0 + c], counts[row0:row0 + c],
                        valid[row0:row0 + c], contours, counts, valid)      # (C, M)
    pair_d2[row0:row0 + c] = rows
    pair_d2[:, row0:row0 + c] = rows.T
    return pair_d2


def update_pair_d2_many(pair_d2: torch.Tensor, batch: ClusterSet, shards,
                        cfg: DDCConfig) -> torch.Tensor:
    """Batched ``update_pair_d2``: the rows and columns of every shard in
    ``shards`` (a sequence or an int tensor) from one rectangular
    ``cross_min_d2`` over their C rows each.  A repeated shard writes the
    same values twice, so the result does not depend on repeats or order
    (the reference pads its list to a power of two by repeating an entry;
    nothing here compiles per length, so nothing is padded).  Updates
    ``pair_d2`` in place and returns it."""
    c = cfg.max_clusters
    contours, counts, valid = _flat_slots(batch, cfg)
    dev = pair_d2.device
    shards = torch.as_tensor(shards, dtype=torch.int64, device=dev).reshape(-1)
    rows_idx = (shards[:, None] * c + torch.arange(c, device=dev)[None, :]).reshape(-1)
    rows = cross_min_d2(contours[rows_idx], counts[rows_idx], valid[rows_idx],
                        contours, counts, valid)                            # (mC, M)
    pair_d2[rows_idx] = rows
    pair_d2[:, rows_idx] = rows.T
    return pair_d2


def merge_from_d2(batch: ClusterSet, pair_d2: torch.Tensor, cfg: DDCConfig,
                  exclude: torch.Tensor | None = None
                  ) -> Tuple[ClusterSet, torch.Tensor]:
    """The merge fold given the slot×slot distance matrix: overlap
    predicate → transitive closure → ranked rebuild.  ``exclude``
    ((K,) bool) masks whole shards out of the fold (their map rows are
    all -1 and their sizes and overflow flags are ignored)."""
    _check_cfg(cfg)
    c, v = cfg.max_clusters, cfg.max_verts
    k = batch.valid.shape[0]
    m = k * c
    dev = pair_d2.device
    contours = batch.contours.reshape(m, v, 2)
    counts = batch.counts.reshape(m)
    sizes = batch.sizes.reshape(m)
    valid = batch.valid.reshape(m)
    if exclude is not None:
        valid = valid & ~exclude.repeat_interleave(c)
    r = cfg.merge_radius
    # r*r is a compile-time constant of the reference, squared in float64
    # and rounded once to float32.
    thr = torch.tensor(r * r, dtype=torch.float32, device=dev)
    overlap = (pair_d2 <= thr) & valid[:, None] & valid[None, :]
    overlap = overlap | (torch.eye(m, dtype=torch.bool, device=dev) & valid[:, None])

    idx = torch.arange(m, dtype=torch.int32, device=dev)
    comp = _components(overlap, valid)                           # (M,)
    roots = valid & (comp == idx)
    comp_safe = comp.clamp(0, m - 1).long()
    comp_size = torch.zeros((m,), dtype=torch.int32, device=dev)
    comp_size.index_add_(0, comp_safe, torch.where(valid, sizes, 0))

    # Rank component roots by size (desc, ties by slot index); keep top C.
    rank_key = torch.where(roots, comp_size, -1)
    order = torch.argsort(-rank_key, stable=True)
    kept = idx < c
    new_slot_of_root = torch.full((m,), -1, dtype=torch.int32, device=dev)
    new_slot_of_root[order] = torch.where(kept & (rank_key[order] > 0), idx, -1)
    slot_of_old = torch.where(valid, new_slot_of_root[comp_safe], -1)  # (M,)

    n_components = roots.sum(dtype=torch.int32)
    shard_overflow = batch.overflow if exclude is None else batch.overflow & ~exclude
    overflow = shard_overflow.any() | (n_components > c)

    # Merged contours: one raster (or one farthest-point subsample) per new
    # slot over its members' vertices.
    flat_pts = contours.reshape(m * v, 2)
    vert_valid = geometry.vert_validity(counts, valid, v)       # (M, V)
    slot = torch.arange(c, dtype=torch.int32, device=dev)
    member = slot_of_old[None, :] == slot[:, None]               # (C, M)
    pmask = (member[:, :, None] & vert_valid[None]).reshape(c, m * v)
    if cfg.merge_refine == "grid":
        nc, ncnt = geometry.extract_contour(flat_pts, pmask, cfg.bounds, cfg.grid, v)
    else:
        nc, ncnt = geometry.farthest_point_subsample(flat_pts, pmask, v)
    nsize = torch.where(member, sizes[None, :], 0).sum(dim=1, dtype=torch.int32)
    nvalid = nsize > 0
    merged = ClusterSet(
        contours=nc,
        counts=torch.where(nvalid, ncnt, 0),
        sizes=nsize,
        valid=nvalid,
        overflow=overflow,
    )
    return merged, slot_of_old.reshape(k, c)


def merge_delta(batch: ClusterSet, pair_d2: torch.Tensor | None, dirty, cfg: DDCConfig,
                exclude: torch.Tensor | None = None
                ) -> Tuple[ClusterSet, torch.Tensor, torch.Tensor]:
    """The aggregator side of a delta exchange: fold the dirty shards'
    fresh ClusterSets (already written into ``batch``) into a cached
    slot-distance matrix and re-close the merge.  With a cached
    ``pair_d2`` and a ``dirty`` list, one dirty shard patches through
    ``update_pair_d2`` and several through one ``update_pair_d2_many``
    (in place); with ``pair_d2=None`` or ``dirty=None`` the matrix is
    rebuilt by the square form (``contour_pair_d2``: each unordered pair
    of valid slots tested once, faster than the rectangular
    ``contour_pair_d2_exact``, the same bits).  Both give the
    bit-identical matrix, so the fold below gives the same global set and
    maps.
    ``exclude`` ((K,) bool) masks quarantined shards out of the fold
    (``merge_from_d2``) and leaves their cached rows as they are.  The
    patch is the reference's interface: on an H100 at 256 slots its
    gathers and scatters around one B5 launch cost more device time than
    the rebuild (PERF.md §5).
    Returns (global ClusterSet, maps (K, C), pair_d2)."""
    if pair_d2 is None or dirty is None:
        pair_d2 = contour_pair_d2(batch, cfg)
    else:
        dirty = [int(i) for i in dirty]
        if len(dirty) == 1:
            pair_d2 = update_pair_d2(pair_d2, batch, dirty[0], cfg)
        elif len(dirty) > 1:
            pair_d2 = update_pair_d2_many(pair_d2, batch, dirty, cfg)
    merged, maps = merge_from_d2(batch, pair_d2, cfg, exclude)
    return merged, maps, pair_d2


def merge_many(batch: ClusterSet, cfg: DDCConfig) -> Tuple[ClusterSet, torch.Tensor]:
    """Fold a stacked batch of ClusterSets — contours (K, C, V, 2),
    counts/sizes/valid (K, C), overflow (K,) — into one.  Returns
    (merged, maps) where maps (K, C) sends every input slot to its output
    slot or -1.  Components are ranked by total member count, ties by
    slot index."""
    return merge_from_d2(batch, contour_pair_d2(batch, cfg), cfg)


def merge_pair(a: ClusterSet, b: ClusterSet, cfg: DDCConfig):
    """Merge two ClusterSets — a batch-2 ``merge_many``.  Returns
    (merged, map_a, map_b)."""
    merged, maps = merge_many(stack_clustersets([a, b]), cfg)
    return merged, maps[0], maps[1]


# ---------------------------------------------------------------------------
# Phase-2 schedules on one device
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CommMeter:
    """Comm-volume accounting for the phase-2 schedules: the same fields,
    hooks and ``snapshot()`` as the reference's trace-time meter.

    The reference counts while its schedules trace, so each collective
    and each merge of the schedule counts once, not once per lane; the
    one-device schedules here count the same way, on every run (``reset()``
    between runs).  ``bytes_total`` sums message bytes over every
    lane→lane link (an all-gather among K lanes of a B-byte buffer counts
    K·(K−1)·B, a ppermute B per (src, dst) pair).  ``merge_steps`` counts
    merges on the critical path; ``merge_slots`` sums the K·C slot counts
    those merges closed over.
    """

    bytes_total: int = 0
    collectives: int = 0
    merge_steps: int = 0
    merge_slots: int = 0

    def add_collective(self, links: int, nbytes: int) -> None:
        self.bytes_total += links * nbytes
        self.collectives += 1

    def add_merge(self, batch: int, slots: int) -> None:
        self.merge_steps += 1
        self.merge_slots += batch * slots

    def reset(self) -> None:
        self.bytes_total = self.collectives = 0
        self.merge_steps = self.merge_slots = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


def lane_set(batch: ClusterSet, i: int) -> ClusterSet:
    """Lane ``i``'s ClusterSet of a stacked batch."""
    return ClusterSet(*(t[i] for t in batch))


def _merge(batch: ClusterSet, cfg: DDCConfig, stats: dict | None):
    if stats is not None:
        stats["merge_calls"] = stats.get("merge_calls", 0) + 1
    return merge_many(batch, cfg)


def _lane_bytes(batch: ClusterSet) -> int:
    return compress.pytree_wire_bytes(lane_set(batch, 0))


def _slot_ids(valid: torch.Tensor) -> torch.Tensor:
    """The identity map on the valid slots (last axis), -1 elsewhere."""
    return torch.where(valid, torch.arange(valid.shape[-1], dtype=torch.int32,
                                           device=valid.device), -1)


def _compose(my_map: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """Follow a slot map by one merge's map; -1 stays -1."""
    return torch.where(my_map >= 0, step[my_map.clamp(min=0).long()], -1)


def merge_sync(batch: ClusterSet, cfg: DDCConfig, meter: CommMeter | None = None,
               stats: dict | None = None) -> Tuple[ClusterSet, torch.Tensor]:
    """Barrier schedule: every lane all-gathers the K ClusterSets of the
    stacked ``batch`` and folds them in ONE ``merge_many``.  Returns (global
    ClusterSet, maps (K, C): each lane's local-slot → global-slot map, -1
    for invalid slots).  ``stats["merge_calls"]`` counts the merges run."""
    k = batch.valid.shape[0]
    if meter is not None:
        meter.add_collective(k * (k - 1), _lane_bytes(batch))
        meter.add_merge(k, cfg.max_clusters)
    gcs, maps = _merge(batch, cfg, stats)
    return gcs, torch.where(batch.valid, maps, -1)


def merge_async(batch: ClusterSet, cfg: DDCConfig, meter: CommMeter | None = None,
                stats: dict | None = None) -> Tuple[ClusterSet, torch.Tensor]:
    """Butterfly (recursive-doubling) schedule: log2(K) rounds in which
    lane ``me`` exchanges its accumulated ClusterSet with lane
    ``me ^ stride`` and both fold the pair, lower lane first, in a batch-2
    merge.  The lanes of one aligned block of 2·stride lanes hold equal
    accumulators, so every pair of the block folds the same two sets: the
    fold runs once per block and every lane of the block takes its side's
    map from it.  K must be a power of two."""
    k = batch.valid.shape[0]
    if k < 1 or k & (k - 1):
        raise ValueError(f"the async schedule needs a power-of-two lane count, got {k}")
    maps = _slot_ids(batch.valid)
    acc = [lane_set(batch, i) for i in range(k)]
    stride = 1
    while stride < k:
        if meter is not None:
            meter.add_collective(k, _lane_bytes(batch))
            meter.add_merge(2, cfg.max_clusters)
        for base in range(0, k, 2 * stride):
            pair = stack_clustersets([acc[base], acc[base + stride]])
            merged, pair_maps = _merge(pair, cfg, stats)
            for me in range(base, base + 2 * stride):
                maps[me] = _compose(maps[me], pair_maps[0 if me < base + stride else 1])
                acc[me] = merged
        stride *= 2
    return acc[0], maps


def _tree_strides(k: int, d: int) -> list:
    """The tree's level strides 1, D, D², … below K."""
    strides, stride = [], 1
    while stride < k:
        strides.append(stride)
        stride *= d
    return strides


def _tree_up_perm(k: int, d: int, stride: int, j: int) -> list:
    """(member, leader) pairs of the level at ``stride`` for the j-th
    member of each group: the reference's ppermute list."""
    off = j * stride
    return [(i, i - off) for i in range(k) if i - off >= 0 and (i // stride) % d == j
            and (i - off) // (stride * d) == i // (stride * d)]


def _tree_down_perm(k: int, d: int, stride: int, j: int) -> list:
    """(leader, j-th member) pairs of the broadcast down the level at
    ``stride``."""
    return [(b, b + j * stride) for b in range(0, k, stride * d) if b + j * stride < k]


def _tree_members(k: int, d: int, stride: int) -> list:
    """Member offsets j of a level's groups that lie below K in the first
    group (a later group may lack some; its leader folds the empty set)."""
    return [j for j in range(1, d) if j * stride < k]


def merge_tree(batch: ClusterSet, cfg: DDCConfig, meter: CommMeter | None = None,
               stats: dict | None = None) -> Tuple[ClusterSet, torch.Tensor]:
    """The paper's Algorithm 2 with degree D = ``cfg.tree_degree``: at each
    level lanes form groups {base, base + stride, …, base + (D−1)·stride}
    of the aligned block of D·stride lanes, the members send to the leader
    ``base`` and the leader folds its group in one batch-D merge (a member
    past the last lane arrives as the all-invalid set, as a ppermute
    delivers zeros); then the root broadcasts the global set down the
    tree, lane 0 keeps the map it composed and every other lane matches
    its local slots to the global set (``match_to_global``).

    Only the leaders fold here: in the reference every lane folds its
    batch and a non-leader drops the result, which changes nothing that
    any lane returns.  The meter counts every ppermute the reference
    issues, with its full permutation list."""
    k = batch.valid.shape[0]
    d = cfg.tree_degree
    if d < 2:
        raise ValueError(f"tree_degree must be >= 2, got {d}")
    c = cfg.max_clusters
    nbytes = _lane_bytes(batch)
    acc = [lane_set(batch, i) for i in range(k)]
    empty = empty_clusterset(cfg, batch.valid.device)
    root_map = _slot_ids(batch.valid[0])
    strides = _tree_strides(k, d)
    for stride in strides:
        members = _tree_members(k, d, stride)
        if meter is not None:
            for j in members:
                meter.add_collective(len(_tree_up_perm(k, d, stride, j)), nbytes)
            meter.add_merge(1 + len(members), c)
        for base in range(0, k, stride * d):
            group = [acc[base]] + [acc[base + j * stride] if base + j * stride < k else empty
                                   for j in members]
            acc[base], group_maps = _merge(stack_clustersets(group), cfg, stats)
            if base == 0:
                root_map = _compose(root_map, group_maps[0])
    gcs = acc[0]
    if meter is not None:
        for stride in reversed(strides):
            for j in _tree_members(k, d, stride):
                meter.add_collective(len(_tree_down_perm(k, d, stride, j)), nbytes)
    maps = [root_map] + [match_to_global(lane_set(batch, i), gcs, cfg) for i in range(1, k)]
    return gcs, torch.stack(maps)


MATCH_CHUNK = 1 << 21  # vertex pairs per chunk of match_to_global


def match_to_global(cs: ClusterSet, gcs: ClusterSet, cfg: DDCConfig) -> torch.Tensor:
    """Map each local cluster to the global cluster whose contour comes
    nearest (min vertex-pair squared distance, within ``merge_radius``);
    (C,) int32 slot ids, -1 for invalid slots and slots with no global
    cluster in reach.  Ties go to the lower global slot.  The squared
    distance is fma(dy, dy, dx·dx), as the compiled reference's
    ``sum((a − b) ** 2, -1)``."""
    c, v = cfg.max_clusters, cfg.max_verts
    dev = cs.contours.device
    gvalid = geometry.vert_validity(gcs.counts, gcs.valid, v).reshape(c * v)
    gflat = gcs.contours.reshape(c * v, 2)
    vi = geometry.vert_validity(cs.counts, cs.valid, v)                   # (C, V)
    r = cfg.merge_radius
    thr = torch.tensor(r * r, dtype=torch.float32, device=dev)
    out = torch.full((c,), -1, dtype=torch.int32, device=dev)
    rows = torch.nonzero(cs.valid).flatten()       # an invalid slot maps to -1
    step = max(1, MATCH_CHUNK // (v * c * v))
    for r0 in range(0, rows.shape[0], step):
        idx = rows[r0:r0 + step]
        diff = cs.contours[idx][:, :, None, :] - gflat[None, None, :, :]  # (s, V, C·V, 2)
        d2 = fma_f32(diff[..., 1], diff[..., 1], diff[..., 0] * diff[..., 0])
        d2 = torch.where(vi[idx][:, :, None] & gvalid[None, None, :], d2, geometry.BIG)
        per_g = d2.reshape(idx.shape[0], v, c, v).amin(dim=(1, 3))       # (s, C)
        best = per_g.argmin(dim=1)
        ok = per_g.gather(1, best[:, None])[:, 0] <= thr
        out[idx] = torch.where(ok, best, -1).to(torch.int32)
    return out


SCHEDULE_FNS = {"sync": merge_sync, "async": merge_async, "tree": merge_tree}


# ---------------------------------------------------------------------------
# Phase 2 across processes: the schedules as collectives over a
# torch.distributed group, one shard a rank
# ---------------------------------------------------------------------------


class Wire:
    """A ClusterSet's trip between the ranks of a ``torch.distributed``
    group: the five leaves packed into one uint8 message of
    ``pytree_wire_bytes`` bytes, copied to the host (the group's backend,
    gloo, moves host memory), sent, and copied back to the rank's device.
    This is the inter-node message of the paper's phase 2.  ``sent``
    counts the bytes of this rank's messages over every link: an
    all-gather's buffer once for each other rank, a send once."""

    def __init__(self, group, cfg: DDCConfig, device):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = torch.device(device)
        c, v = cfg.max_clusters, cfg.max_verts
        self.shapes = ((c, v, 2), (c,), (c,), (c,), ())
        self.nbytes = cfg.buffer_bytes()
        self.sent = 0

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def pack(self, cs: ClusterSet) -> torch.Tensor:
        return torch.cat([t.reshape(-1).view(torch.uint8) for t in cs]).cpu()

    def unpack(self, buf: torch.Tensor) -> ClusterSet:
        buf = buf.to(self.device)
        leaves, o = [], 0
        for shape, dt in zip(self.shapes, _CS_DTYPES):
            nb = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            leaves.append(buf[o:o + nb].view(dt).reshape(shape))
            o += nb
        return ClusterSet(*leaves)

    def all_gather(self, cs: ClusterSet) -> list:
        """Every rank's ClusterSet, in rank order."""
        out = [torch.empty(self.nbytes, dtype=torch.uint8) for _ in range(self.size)]
        dist.all_gather(out, self.pack(cs), group=self.group)
        self.sent += (self.size - 1) * self.nbytes
        return [self.unpack(b) for b in out]

    def exchange(self, sends: dict, srcs: list) -> list:
        """Send ``sends[dst]`` to each dst and receive one ClusterSet from
        each of ``srcs`` (group ranks), as one batch of point-to-point
        operations — the counterpart of a ppermute hop.  Returns the
        received sets in ``srcs``' order."""
        packed: dict = {}
        ops = []
        for dst, cs in sends.items():
            buf = packed.setdefault(id(cs), self.pack(cs))
            ops.append(dist.P2POp(dist.isend, buf, self._peer(dst), self.group))
            self.sent += self.nbytes
        got = [torch.empty(self.nbytes, dtype=torch.uint8) for _ in srcs]
        ops += [dist.P2POp(dist.irecv, buf, self._peer(src), self.group)
                for buf, src in zip(got, srcs)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [self.unpack(b) for b in got]


def merge_sync_shard(cs: ClusterSet, cfg: DDCConfig, wire: Wire,
                     meter: CommMeter | None = None,
                     stats: dict | None = None) -> Tuple[ClusterSet, torch.Tensor]:
    """``merge_sync`` across ranks: all-gather every rank's ClusterSet and
    fold the K·C slots in ONE ``merge_many``; each rank takes its row of
    the maps.  Returns (global ClusterSet, this rank's local → global slot
    map (C,))."""
    k, me = wire.size, wire.rank
    if meter is not None:
        meter.add_collective(k * (k - 1), wire.nbytes)
        meter.add_merge(k, cfg.max_clusters)
    gcs, maps = _merge(stack_clustersets(wire.all_gather(cs)), cfg, stats)
    return gcs, torch.where(cs.valid, maps[me], -1)


def merge_async_shard(cs: ClusterSet, cfg: DDCConfig, wire: Wire,
                      meter: CommMeter | None = None,
                      stats: dict | None = None) -> Tuple[ClusterSet, torch.Tensor]:
    """``merge_async`` across ranks: log2(K) rounds in which rank ``me``
    swaps its accumulated ClusterSet with rank ``me ^ stride`` and folds
    the pair, lower rank first, in a batch-2 merge — every rank its own
    pair, as the reference's lanes do.  K must be a power of two."""
    k, me = wire.size, wire.rank
    if k & (k - 1):
        raise ValueError(f"the async schedule needs a power-of-two lane count, got {k}")
    my_map, acc = _slot_ids(cs.valid), cs
    stride = 1
    while stride < k:
        if meter is not None:
            meter.add_collective(k, wire.nbytes)
            meter.add_merge(2, cfg.max_clusters)
        partner = wire.exchange({me ^ stride: acc}, [me ^ stride])[0]
        low = not me & stride
        acc, pair_maps = _merge(stack_clustersets([acc, partner] if low else [partner, acc]),
                                cfg, stats)
        my_map = _compose(my_map, pair_maps[0 if low else 1])
        stride *= 2
    return acc, my_map


def merge_tree_shard(cs: ClusterSet, cfg: DDCConfig, wire: Wire,
                     meter: CommMeter | None = None,
                     stats: dict | None = None) -> Tuple[ClusterSet, torch.Tensor]:
    """``merge_tree`` across ranks: at each level the members send their
    accumulated set to their leader, one point-to-point hop per (level,
    member) on the reference's permutation lists, and the leader folds
    its group in one batch-D ``merge_many`` (the empty set for a member
    past the last rank); non-leaders do not fold.  The root then sends
    the global set down the same tree, hop by hop; rank 0 keeps the map
    it composed and every other rank matches its local slots to the
    global set (``match_to_global``)."""
    k, me, d = wire.size, wire.rank, cfg.tree_degree
    if d < 2:
        raise ValueError(f"tree_degree must be >= 2, got {d}")
    c = cfg.max_clusters
    my_map, acc = _slot_ids(cs.valid), cs
    strides = _tree_strides(k, d)
    for stride in strides:
        members = _tree_members(k, d, stride)
        perms = [_tree_up_perm(k, d, stride, j) for j in members]
        if meter is not None:
            for perm in perms:
                meter.add_collective(len(perm), wire.nbytes)
            meter.add_merge(1 + len(members), c)
        srcs = [src for perm in perms for src, dst in perm if dst == me]
        got = dict(zip(srcs, wire.exchange(
            {dst: acc for perm in perms for src, dst in perm if src == me}, srcs)))
        if me % (stride * d) == 0:
            empty = empty_clusterset(cfg, wire.device)
            group = [acc] + [got.get(me + j * stride, empty) for j in members]
            acc, group_maps = _merge(stack_clustersets(group), cfg, stats)
            if me == 0:
                my_map = _compose(my_map, group_maps[0])
    gcs = acc
    for stride in reversed(strides):
        perms = [_tree_down_perm(k, d, stride, j) for j in _tree_members(k, d, stride)]
        if meter is not None:
            for perm in perms:
                meter.add_collective(len(perm), wire.nbytes)
        srcs = [src for perm in perms for src, dst in perm if dst == me]
        got = wire.exchange({dst: gcs for perm in perms for src, dst in perm if src == me},
                            srcs)
        if got:
            gcs = got[0]
    if me != 0:
        my_map = match_to_global(cs, gcs, cfg)
    return gcs, my_map


SHARD_SCHEDULE_FNS = {"sync": merge_sync_shard, "async": merge_async_shard,
                      "tree": merge_tree_shard}


def ddc_shard(points: torch.Tensor, mask: torch.Tensor, cfg: DDCConfig, group=None, *,
              seed: int = 0, init=None, meter: CommMeter | None = None,
              trace: dict | None = None):
    """Full DDC on one rank of a ``torch.distributed`` group (the default
    group when ``group`` is None): phase 1 on this rank's shard, on the
    device its tensors lie on, then phase 2 across the group's ranks with
    ``cfg.schedule`` (``merge_sync_shard``, ``merge_async_shard``,
    ``merge_tree_shard``); only ClusterSets cross between ranks.  Returns
    (global labels of the local points (n,) i32, global ClusterSet, local
    → global slot map (C,) i32) — the reference's ``ddc_shard``.

    ``seed`` / ``init`` ((k, 2) initial centres) seed a K-Means shard as
    in ``local_phase``.  ``meter`` counts what the schedule moves in the
    whole group, as the reference's trace-time meter does (every rank's
    meter gets the same counts).  A ``trace`` dict is filled with the
    shard's DBSCANResult or KMeansResult (``result``), dense labels, path,
    ClusterSet, the schedule, ``merge_calls``, ``sent_bytes`` (this rank's
    share of the meter's bytes, ``Wire.sent``) and the wall times
    ``phase1_s`` and ``phase2_s`` (the wire included)."""
    _check_cfg(cfg)
    k = dist.get_world_size(group)
    if cfg.schedule == "async" and k & (k - 1):
        raise ValueError(f"the async schedule needs a power-of-two lane count, got {k}")
    dev = points.device
    _sync(dev)
    t0 = time.perf_counter()
    res, dense, cs, path = _local_phase(points, mask, cfg, seed,
                                        None if init is None else torch.as_tensor(init,
                                                                                  device=dev))
    _sync(dev)
    t1 = time.perf_counter()
    wire = Wire(group, cfg, dev)
    stats = {"merge_calls": 0}
    gcs, my_map = SHARD_SCHEDULE_FNS[cfg.schedule](cs, cfg, wire, meter, stats)
    glabels = torch.where(dense >= 0, my_map[dense.clamp(min=0).long()], -1).to(torch.int32)
    _sync(dev)
    t2 = time.perf_counter()
    if trace is not None:
        trace.update(result=res, dense=dense, path=path, cs=cs, schedule=cfg.schedule,
                     merge_calls=stats["merge_calls"], sent_bytes=wire.sent,
                     phase1_s=t1 - t0, phase2_s=t2 - t1)
    return glabels, gcs, my_map


# ---------------------------------------------------------------------------
# Whole pipeline on one device
# ---------------------------------------------------------------------------


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_ddc_fn(cfg: DDCConfig, shards: int, *, device="cuda",
                meter: CommMeter | None = None, seed: int = 0, init=None):
    """Build the one-device DDC entry point for any ``DDCConfig``.

    ``run(points, mask, trace=None)`` takes (N, 2) points and an (N,)
    mask (tensors or arrays; moved to ``device``), splits them into
    ``shards`` equal lanes, runs ``local_phase`` on each lane in turn,
    folds the lanes' ClusterSets with ``cfg.schedule``, and returns
    (global labels (N,) i32, global ClusterSet, local→global slot map
    (shards·C,) i32) — the reference's shapes and values.

    ``meter`` (a ``CommMeter``) is filled on every run with what the
    reference's collectives would move.  K-Means lanes all seed from
    ``seed``, as the reference's lanes all seed from one key; ``init``
    ((shards, k, 2)) gives each lane's initial centres instead.  A
    ``trace`` dict is filled with the per-lane DBSCANResults or
    KMeansResults (``results``), dense labels, paths (``paths``: {"path":
    "dense" | "sparse" | "dense_fallback", "n_active", "frac"} per DBSCAN
    lane, {"path": "kmeans"} per K-Means lane), the stacked ClusterSets,
    the schedule, the number of ``merge_many`` calls (``merge_calls``) and
    the wall time of each phase.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_ddc_fn: device 'cuda' requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    _check_cfg(cfg)
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if cfg.schedule == "async" and shards & (shards - 1):
        raise ValueError(f"the async schedule needs a power-of-two shard count, got {shards}")
    schedule = SCHEDULE_FNS[cfg.schedule]

    def run(points, mask, trace: dict | None = None):
        points = torch.as_tensor(points, device=dev).to(torch.float32)
        mask = torch.as_tensor(mask, device=dev).to(torch.bool)
        n = points.shape[0]
        if n % shards or mask.shape != (n,):
            raise ValueError(f"{n} points do not split into {shards} equal lanes")
        per = n // shards
        _sync(dev)
        t0 = time.perf_counter()
        lanes = [_local_phase(points[i * per:(i + 1) * per], mask[i * per:(i + 1) * per],
                              cfg, seed, None if init is None else
                              torch.as_tensor(init[i], device=dev))
                 for i in range(shards)]
        batch = stack_clustersets([cs for _, _, cs, _ in lanes])
        _sync(dev)
        t1 = time.perf_counter()
        stats: dict = {"merge_calls": 0}
        gcs, maps = schedule(batch, cfg, meter, stats)                   # maps (K, C)
        glabels = torch.cat([
            torch.where(dense >= 0, maps[i][dense.clamp(min=0).long()], -1)
            for i, (_, dense, _, _) in enumerate(lanes)])
        _sync(dev)
        t2 = time.perf_counter()
        if trace is not None:
            trace.update(results=[lane[0] for lane in lanes],
                         dense=[lane[1] for lane in lanes],
                         paths=[lane[3] for lane in lanes],
                         batch=batch, schedule=cfg.schedule,
                         merge_calls=stats["merge_calls"],
                         phase1_s=t1 - t0, phase2_s=t2 - t1)
        return glabels.to(torch.int32), gcs, maps.reshape(-1)

    return run


# ---------------------------------------------------------------------------
# Host (paper-faithful) path — NumPy oracle
# ---------------------------------------------------------------------------


def same_clustering(a: np.ndarray, b: np.ndarray) -> bool:
    """True iff two label arrays describe the IDENTICAL clustering: the
    same noise set (label < 0) and a bijection between cluster labels."""
    a = np.asarray(a)
    b = np.asarray(b)
    if ((a < 0) != (b < 0)).any():
        return False
    m = a >= 0
    pairs = set(zip(a[m].tolist(), b[m].tolist()))
    return len(pairs) == len(set(a[m].tolist())) == len(set(b[m].tolist()))


def ddc_host(
    points: np.ndarray,
    n_partitions: int,
    eps: float,
    min_pts: int,
    partition: str = "block",
    contour: str = "hull",
):
    """Reference DDC on the host: ``dbscan_ref`` per partition, exact
    polygon-overlap merge (the paper's phase-2 predicate).

    ``partition``: "block" (contiguous array_split), "strided", or an
    explicit list of index arrays (one per shard).  Returns (global
    labels (n,), list of merged-cluster polygons, exchanged_points: how
    many contour vertices crossed the 'network')."""
    n = len(points)
    if isinstance(partition, (list, tuple)):
        parts = [np.asarray(p, dtype=np.int64) for p in partition]
    elif partition == "block":
        parts = np.array_split(np.arange(n), n_partitions)
    else:
        parts = [np.arange(n)[i::n_partitions] for i in range(n_partitions)]
    labels = np.full(n, -1, np.int64)
    polys: list = []       # (part, local_cluster, polygon, member_idx)
    exchanged = 0
    for pi, idx in enumerate(parts):
        if len(idx) == 0:
            continue
        local = dbscan_mod.dbscan_ref(points[idx], eps, min_pts)
        for cid in sorted(set(local[local >= 0])):
            members = idx[local == cid]
            if contour == "hull":
                poly = geometry.convex_hull_np(points[members])
            else:
                x0, y0 = points[:, 0].min(), points[:, 1].min()
                x1, y1 = points[:, 0].max(), points[:, 1].max()
                poly = geometry.grid_contour_np(points[members], (x0, y0, x1, y1), 128)
            polys.append({"members": members, "poly": poly})
            exchanged += len(poly)

    # Union-find over polygons by exact overlap (dilated by eps: two
    # clusters merge when their polygons overlap or come within eps).
    m = len(polys)
    parent = list(range(m))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(i, j):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)

    for i in range(m):
        for j in range(i + 1, m):
            a, b = polys[i]["poly"], polys[j]["poly"]
            # Hull contours are ordered polygons: exact overlap test.
            # Grid contours are unordered boundary samples: proximity only
            # (this is what preserves non-convexity).
            if contour == "hull":
                hit = polygons_near(a, b, eps)
            else:
                d = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)).min()
                hit = bool(d <= eps * 1.5)
            if hit:
                union(i, j)

    global_ids = {}
    for i in range(m):
        r = find(i)
        gid = global_ids.setdefault(r, len(global_ids))
        labels[polys[i]["members"]] = gid
    return labels, polys, exchanged


def polygons_near(a: np.ndarray, b: np.ndarray, eps: float) -> bool:
    """Exact overlap OR min vertex-to-vertex distance <= eps (clusters
    that touch across a partition boundary merge, matching DBSCAN)."""
    if len(a) == 0 or len(b) == 0:
        return False
    if geometry.polygons_overlap_np(a, b):
        return True
    d = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)).min()
    return bool(d <= eps)
