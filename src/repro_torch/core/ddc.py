"""Dynamic Distributed Clustering (DDC) — the paper's contribution, on one
device.

Phase 1 (per shard, zero communication): every shard clusters its local
points with DBSCAN and reduces each cluster to a fixed-size contour
buffer.  Phase 2: the shards' contours merge by contour proximity into
global clusters, in one batched fold over all K·C cluster slots
(``merge_many``): the slot×slot min-distance matrix comes from one
kernel call, the overlap graph's components from pointer-doubled label
propagation, and merged contours are re-extracted on the global raster.

``make_ddc_fn`` is the one-device form of the reference's distributed
entry point with the ``sync`` schedule: the K shard lanes run one after
another on one device, and the merge sees the same stacked batch the
all-gather would deliver.

Host path: ``ddc_host`` (NumPy, exact polygon-overlap merge) is the
paper-faithful oracle.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import dbscan as dbscan_mod
from repro_torch.core import geometry
from repro_torch.kernels import ops

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


def _check_cfg(cfg: DDCConfig) -> None:
    if cfg.local_algo != "dbscan":
        raise NotImplementedError(
            f"local_algo={cfg.local_algo!r} is not ported yet (kmeans needs "
            "the pairwise_dist_sq kernel); use 'dbscan'")
    if cfg.merge_refine != "grid":
        raise NotImplementedError(
            f"merge_refine={cfg.merge_refine!r} is not ported yet; use 'grid'")


# ---------------------------------------------------------------------------
# Phase 1 — local clustering + contour reduction
# ---------------------------------------------------------------------------


def _local_phase(points: torch.Tensor, mask: torch.Tensor, cfg: DDCConfig):
    """``local_phase`` that also returns the shard's DBSCANResult and the
    DBSCAN path it took (``dbscan_traced``)."""
    _check_cfg(cfg)
    c = cfg.max_clusters
    dev = points.device
    res, path = dbscan_mod.dbscan_traced(points, mask, cfg.eps, cfg.min_pts,
                                         block_sparse=cfg.block_sparse, bt=cfg.block_tile)
    dense = dbscan_mod.relabel_dense(res.labels, c)
    sizes = torch.zeros((c,), dtype=torch.int32, device=dev)
    sizes.index_add_(0, dense.clamp(min=0).long(), (dense >= 0).to(torch.int32))
    valid = sizes > 0
    slot = torch.arange(c, dtype=torch.int32, device=dev)
    members = mask[None, :] & (dense[None, :] == slot[:, None])          # (C, n)
    contours, counts = geometry.extract_contour(
        points.to(torch.float32), members, cfg.bounds, cfg.grid, cfg.max_verts)
    cs = ClusterSet(
        contours=contours,
        counts=torch.where(valid, counts, 0),
        sizes=sizes,
        valid=valid,
        overflow=res.n_clusters > c,
    )
    return res, dense, cs, path


def local_phase(points: torch.Tensor, mask: torch.Tensor,
                cfg: DDCConfig) -> Tuple[torch.Tensor, ClusterSet]:
    """Cluster a shard's points and reduce them to contours, on the
    device the tensors lie on.  Returns (dense local labels (n,) i32,
    ClusterSet).  Zero communication."""
    _, dense, cs, _ = _local_phase(points, mask, cfg)
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


def contour_pair_d2(batch: ClusterSet, cfg: DDCConfig) -> torch.Tensor:
    """The (K·C, K·C) slot×slot min-contour-distance matrix of a stacked
    batch — one kernel call (``ops.contour_min_d2``)."""
    c, v = cfg.max_clusters, cfg.max_verts
    m = batch.valid.shape[0] * c
    return ops.contour_min_d2(
        batch.contours.reshape(m, v, 2).contiguous(),
        batch.counts.reshape(m).contiguous(),
        batch.valid.reshape(m).contiguous(),
    )


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

    # Merged contours: one raster per new slot over its members' vertices.
    flat_pts = contours.reshape(m * v, 2)
    vert_valid = geometry.vert_validity(counts, valid, v)       # (M, V)
    slot = torch.arange(c, dtype=torch.int32, device=dev)
    member = slot_of_old[None, :] == slot[:, None]               # (C, M)
    pmask = (member[:, :, None] & vert_valid[None]).reshape(c, m * v)
    nc, ncnt = geometry.extract_contour(flat_pts, pmask, cfg.bounds, cfg.grid, v)
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
# Whole pipeline on one device
# ---------------------------------------------------------------------------


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_ddc_fn(cfg: DDCConfig, shards: int, *, device="cuda"):
    """Build the one-device DDC entry point with the ``sync`` schedule.

    ``run(points, mask, trace=None)`` takes (N, 2) points and an (N,)
    mask (tensors or arrays; moved to ``device``), splits them into
    ``shards`` equal lanes, runs ``local_phase`` on each lane in turn,
    merges the stacked lanes' ClusterSets with one ``merge_many``, and
    returns (global labels (N,) i32, global ClusterSet, local→global slot
    map (shards·C,) i32) — the reference's shapes.  A ``trace`` dict is
    filled with the per-lane DBSCANResults, dense labels and DBSCAN paths
    (``paths``: {"path": "dense" | "sparse" | "dense_fallback",
    "n_active", "frac"} per lane), the stacked ClusterSets and the wall
    time of each phase.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_ddc_fn: device 'cuda' requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if cfg.schedule != "sync":
        raise NotImplementedError(
            f"schedule={cfg.schedule!r} is not ported yet; use 'sync'")
    _check_cfg(cfg)
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")

    def run(points, mask, trace: dict | None = None):
        points = torch.as_tensor(points, device=dev).to(torch.float32)
        mask = torch.as_tensor(mask, device=dev).to(torch.bool)
        n = points.shape[0]
        if n % shards or mask.shape != (n,):
            raise ValueError(f"{n} points do not split into {shards} equal lanes")
        per = n // shards
        _sync(dev)
        t0 = time.perf_counter()
        lanes = [_local_phase(points[i * per:(i + 1) * per],
                              mask[i * per:(i + 1) * per], cfg)
                 for i in range(shards)]
        batch = stack_clustersets([cs for _, _, cs, _ in lanes])
        _sync(dev)
        t1 = time.perf_counter()
        gcs, maps = merge_many(batch, cfg)
        my_map = torch.where(batch.valid, maps, -1)                  # (K, C)
        glabels = torch.cat([
            torch.where(dense >= 0, my_map[i][dense.clamp(min=0).long()], -1)
            for i, (_, dense, _, _) in enumerate(lanes)])
        _sync(dev)
        t2 = time.perf_counter()
        if trace is not None:
            trace.update(results=[lane[0] for lane in lanes],
                         dense=[lane[1] for lane in lanes],
                         paths=[lane[3] for lane in lanes],
                         batch=batch, phase1_s=t1 - t0, phase2_s=t2 - t1)
        return glabels.to(torch.int32), gcs, my_map.reshape(-1)

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
