"""High-QPS query tier: snapshot-versioned reads over coalesced batches.

Counterpart of the reference package's ``serve/query_tier.py``, on torch
tensors on the serving device.  After every refresh (for the batch
backends: the first read after a write) the engine publishes an
immutable, versioned ``Snapshot`` (per-shard read buffers + global
labels + routing bboxes + the quarantine set, stamped with the refresh
epoch that produced it), and the ``QueryTier`` answers every read from
the last published snapshot (DESIGN.md §12).

Three mechanisms, as in the reference:

* **Snapshot publish/swap** — a snapshot's tensors are fresh copies,
  never aliases of the engine's buffers, so a held snapshot is never
  torn: a query sees version V in full or V+1 in full.
* **Coalescing + pow2 bucketing** — concurrent requests whose ε-dilated
  bbox scan sets overlap are folded into ONE batched launch over the
  union scan set (exact: a shard outside a request's own scan set holds
  no point within ε of its queries, so it can neither produce a hit nor
  steal an argmin tie from one).  Query widths and scan-set widths are
  both padded to powers of two, so the number of distinct launch shapes
  stays under ``cache_bound`` whatever the traffic mix
  (``snapshot_query_cache_entries``).
* **Bounded queue + deadlines + degraded reads** — ``submit`` refuses
  work past ``queue_depth`` (``QueueFull``); a request whose deadline has
  passed by serve time is still answered from the current snapshot and
  counted in ``deadline_misses``; shards quarantined at publish time are
  routed around, shards quarantined after it serve their last-good rows,
  and both surface as ``QueryResult.degraded=True``.

The batched query (``_snapshot_query``) is plain torch on the snapshot's
device.  Its distance is the reference's as XLA:CPU compiles it:
fma(dy, dy, dx·dx) rounded once (``kernels/ref.py::fma_f32``), which
decides ties that the FMA-free dx² + dy² would break the other way; the
argmin takes the first index of a tie over the flattened (scanned shard,
slot) axis, and the hit test is d2 <= eps² with eps² a float32 product.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import BIG, PAIR_CHUNK, eps_sq_f32, fma_f32


# ---------------------------------------------------------------------------
# QueryResult — the structured read-path return value
# ---------------------------------------------------------------------------


class QueryResult:
    """Labels plus the read-path metadata the bare ndarray hid.

    * ``labels`` — (n,) int32 global cluster id per query point (-1 noise);
    * ``version`` — the snapshot version that answered (0: the empty
      service short-circuit, before any snapshot exists);
    * ``degraded`` — True iff a quarantined shard could have mattered:
      either routed around (quarantined at publish) or served stale
      (quarantined after this snapshot was cut);
    * ``scanned_shards`` — the request's own bbox-routed scan set;
    * ``latency_ms`` — submit→answer wall clock for this request.

    Deprecation shim: the object duck-types as ``labels`` (``__array__``,
    comparisons, indexing, attribute forwarding), so callers written
    against the old ``np.ndarray`` return keep working verbatim.
    """

    __slots__ = ("labels", "version", "degraded", "scanned_shards",
                 "latency_ms")

    def __init__(self, labels: np.ndarray, version: int = 0,
                 degraded: bool = False,
                 scanned_shards: Tuple[int, ...] = (),
                 latency_ms: float = 0.0):
        self.labels = np.asarray(labels, np.int32)
        self.version = int(version)
        self.degraded = bool(degraded)
        self.scanned_shards = tuple(int(s) for s in scanned_shards)
        self.latency_ms = float(latency_ms)

    # -- ndarray duck-typing (the legacy-caller shim) -----------------------

    def __array__(self, dtype=None, copy=None):
        out = self.labels if dtype is None else self.labels.astype(dtype)
        return np.array(out) if copy else out

    def __len__(self):
        return len(self.labels)

    def __iter__(self):
        return iter(self.labels)

    def __getitem__(self, idx):
        return self.labels[idx]

    def __eq__(self, other):
        return self.labels == np.asarray(other)

    def __ne__(self, other):
        return self.labels != np.asarray(other)

    def __lt__(self, other):
        return self.labels < np.asarray(other)

    def __le__(self, other):
        return self.labels <= np.asarray(other)

    def __gt__(self, other):
        return self.labels > np.asarray(other)

    def __ge__(self, other):
        return self.labels >= np.asarray(other)

    # Defining __eq__ normally sets __hash__ = None (unhashable) — but the
    # elementwise comparisons above are an ndarray shim, not value equality,
    # so identity hashing is the right contract: callers may dedupe results
    # in a set / key a dict on them (each submit() is a distinct result).
    __hash__ = object.__hash__

    def __getattr__(self, name):
        # Fallback for ndarray attributes/methods (shape, tolist, all, …).
        return getattr(object.__getattribute__(self, "labels"), name)

    def __repr__(self):
        return (f"QueryResult(n={len(self.labels)}, version={self.version}, "
                f"degraded={self.degraded}, "
                f"scanned_shards={self.scanned_shards}, "
                f"latency_ms={self.latency_ms:.3f})")


# ---------------------------------------------------------------------------
# Snapshot — the immutable published read view
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One consistent, immutable read view of a serve engine.

    Cut atomically at the end of a refresh (or a restore): every field
    below was observed from the same engine state, and the tensors are
    copies — the engine's buffers are never aliased — so holding a
    Snapshot across later ingests/refreshes is always safe.
    """

    version: int                    # monotonic publish counter (1-based)
    epoch: int                      # engine refresh count that produced it
    published_at: float             # time.monotonic() at publish
    eps: float
    pts: torch.Tensor               # (K, cap, 2) f32, on the serving device
    mask: torch.Tensor              # (K, cap) bool live mask
    glabels: torch.Tensor           # (K, cap) int32 global labels
    bboxes: Tuple[Optional[tuple], ...]   # per-shard live bbox (None: empty)
    quarantined: frozenset          # shards quarantined at publish time
    n_live: int
    n_clusters: int

    @property
    def shards(self) -> int:
        return len(self.bboxes)

    def age(self) -> float:
        return time.monotonic() - self.published_at


# The one bbox-dilation constant shared by every routing path (the control
# plane's synchronous ``_route``, the dist lanes' scan flags derived from it,
# and ``route_snapshot`` below).  The 1e-6 relative slack absorbs the f32
# round-trip of points through the ring buffers: a query exactly eps away
# from a stored point must still scan that shard.  Duplicating the literal
# per call-site is how the snapshot and sync paths drift apart — never
# inline it again.
ROUTE_EPS_DILATION = 1.0 + 1e-6


def routing_eps(eps: float) -> float:
    """The dilated routing radius used by every bbox scan test."""
    return float(eps) * ROUTE_EPS_DILATION


def bbox_route(bboxes, q: np.ndarray, eps: float) -> np.ndarray:
    """(K,) bool scan flags: which shards' live bboxes could hold a point
    within ``eps`` of ANY query in ``q``.  One float64 point-to-box
    distance test against the ε-dilated radius — the single shared
    implementation behind the sync control-plane route and the snapshot
    route, so a boundary query can never be routed differently by path.

    ``bboxes`` is a per-shard sequence of (x0, y0, x1, y1) or None (no
    live rows → never scanned).
    """
    q64 = np.asarray(q, np.float64).reshape(-1, 2)
    e = routing_eps(eps)
    scan = np.zeros((len(bboxes),), bool)
    for s, box in enumerate(bboxes):
        if box is None:
            continue
        x0, y0, x1, y1 = box
        dx = np.maximum(np.maximum(x0 - q64[:, 0], 0.0), q64[:, 0] - x1)
        dy = np.maximum(np.maximum(y0 - q64[:, 1], 0.0), q64[:, 1] - y1)
        scan[s] = bool(np.any(dx * dx + dy * dy <= e * e))
    return scan


def route_snapshot(snap: Snapshot, q: np.ndarray,
                   quarantined_now=frozenset()) -> Tuple[np.ndarray, bool]:
    """(scan (K,) bool, degraded): the snapshot edition of the control
    plane's ``_route`` — literally the same ``bbox_route`` call (one
    float64 test, one ``ROUTE_EPS_DILATION``), so routing (and therefore
    labels) match the synchronous path bit-for-bit on the same state.

    ``degraded`` is raised when a quarantined shard could have mattered
    for THIS request: one quarantined at publish time (its rows were
    excluded from the snapshot's routing, like the sync path), or one
    quarantined *since* (its last-good rows are still in the snapshot
    and will be served stale).
    """
    k = snap.shards
    scan = bbox_route(snap.bboxes, q, snap.eps)
    degraded = False
    if snap.quarantined:
        qmask = np.zeros((k,), bool)
        qmask[list(snap.quarantined)] = True
        degraded = bool((scan & qmask).any())
        scan &= ~qmask
    stale_only = set(quarantined_now) - set(snap.quarantined)
    if stale_only:
        degraded = degraded or bool(scan[sorted(stale_only)].any())
    return scan, degraded


# ---------------------------------------------------------------------------
# The batched snapshot query
# ---------------------------------------------------------------------------

# The distinct (query bucket, scanned-shard width, capacity) launch shapes
# seen in this process: the count the reference's jit cache holds.
_LAUNCH_SHAPES: set = set()


def _snapshot_query(q, pts, mask, glabels, eps):
    """Nearest clustered live point within eps, else -1 — the reference's
    flat argmin over the snapshot rows.  ``q`` (Qb, 2) is a pow2-bucketed
    batch; ``pts``/``mask``/``glabels`` carry a pow2 scanned-shard axis
    (padded rows masked inert).  Padded query rows compute junk that the
    caller slices off.

    d2 = fma(dy, dy, dx·dx), rounded once, as the jitted reference
    computes it; 1e30 where the row is not a clustered live point; the
    first index of a tie wins (``jnp.argmin``'s rule); a hit is d2 <= eps²
    with eps² a float32 product."""
    _LAUNCH_SHAPES.add((int(q.shape[0]), int(pts.shape[0]), int(pts.shape[1])))
    return nearest_labels(q, pts, mask, glabels, eps)


def nearest_labels(q, pts, mask, glabels, eps):
    """The flat argmin behind ``_snapshot_query`` and the stream engine's
    synchronous query: per row of ``q``, the global label of the nearest
    clustered live row of ``pts`` (any leading shard axis, flattened in
    order) if it lies within eps, else -1.  The query rows go in chunks of
    ``PAIR_CHUNK`` pair tests, which bounds the float64 temporaries of
    ``fma_f32`` and changes no argmin (each row is its own reduction)."""
    flat = pts.reshape(-1, 2)
    ok = (mask & (glabels >= 0)).reshape(-1)
    flab = glabels.reshape(-1)
    eps2 = eps_sq_f32(eps)
    n = flat.shape[0]
    out = torch.empty((q.shape[0],), dtype=torch.int32, device=q.device)
    rows = max(1, PAIR_CHUNK // max(n, 1))
    for r0 in range(0, q.shape[0], rows):
        qc = q[r0:r0 + rows]
        dx = qc[:, 0:1] - flat[None, :, 0]
        dy = qc[:, 1:2] - flat[None, :, 1]
        d2 = torch.where(ok[None, :], fma_f32(dy, dy, dx * dx), BIG)
        j = torch.argmin(d2, dim=1)
        hit = d2.gather(1, j[:, None])[:, 0] <= eps2
        out[r0:r0 + rows] = torch.where(hit, flab[j], -1)
    return out


def snapshot_query_cache_entries() -> int:
    """Distinct launch shapes of the snapshot query seen in this process —
    the number tests bound by the pow2 bucket count (the reference's jit
    cache size)."""
    return len(_LAUNCH_SHAPES)


def clear_snapshot_query_cache() -> None:
    _LAUNCH_SHAPES.clear()


def pow2_bucket(n: int, lo: int, hi: int) -> int:
    """The pow2 width ``n`` rows pad to, clamped to [lo, hi]."""
    n = max(int(n), 1)
    return max(lo, min(1 << (n - 1).bit_length(), hi))


# ---------------------------------------------------------------------------
# Typed service statistics — counters vs gauges, one contract, every backend
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServiceCounters:
    """Monotonic counters: only ever increase over a service's lifetime
    (and survive snapshot/restore).  Rates are meaningful; levels are
    history."""

    refreshes: int = 0              # refresh() invocations that did work
    delta_refreshes: int = 0        # …that took the delta-merge path
    snapshots_published: int = 0    # read views cut (== snapshot_version)
    refits: int = 0                 # batch-backend full-pipeline reruns
    query_chunks: int = 0           # sync-path routed chunks
    query_shards_scanned: int = 0   # sync-path shard scans
    queries_served: int = 0         # tier requests answered
    query_launches: int = 0         # coalesced batched query launches
    coalesced_requests: int = 0     # requests that shared a launch
    query_rows: int = 0             # query points pushed through launches
    deadline_misses: int = 0        # requests answered past their deadline
    degraded_queries: int = 0       # answers that routed around quarantine
    retries: int = 0                # delta re-deliveries
    quarantine_events: int = 0      # shards ever quarantined
    fenced_deltas: int = 0          # duplicates the epoch fence dropped
    journal_entries: int = 0        # write-ahead journal records


@dataclasses.dataclass(frozen=True)
class ServiceGauges:
    """Point-in-time gauges: the state of the service *now*.  May move in
    either direction; comparing across time measures change, not work."""

    shards: int = 0
    capacity: int = 0
    n_live: int = 0
    n_clusters: int = 0
    snapshot_version: int = 0       # last published version (0: none yet)
    snapshot_epoch: int = 0         # refresh count behind that version
    quarantined_now: Tuple[int, ...] = ()
    queue_pending: int = 0          # tier requests awaiting a drain
    jit_cache_entries: int = 0      # snapshot-query launch shapes seen
    # Window age (TTL/sliding-window deployments): the oldest and newest
    # live ingest timestamps, None when no point is live (distinguishing
    # an empty service from a genuine t=0 stamp).
    oldest_ts: Optional[float] = None
    newest_ts: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ServiceStats:
    """The one typed stats contract every backend surfaces
    (``Backend.service_stats()`` / ``DDC.stats()``): monotonic
    ``counters``, point-in-time ``gauges``, and the exact ``comm``
    wire accounting.  ``as_dict()``/``comm_dict()`` are the legacy
    views ``stats()``/``comm_stats()`` now derive from, so the dicts
    and the typed object can never drift."""

    backend: str
    counters: ServiceCounters
    gauges: ServiceGauges
    comm: Dict[str, int] = dataclasses.field(default_factory=dict)

    def as_dict(self, nest_comm: bool = True) -> dict:
        """The engine-``stats()``-shaped flat dict (legacy keys kept:
        ``quarantined_shards`` is the quarantine_events counter,
        ``query_shards_possible`` the chunk-count × shard bound)."""
        c, g = self.counters, self.gauges
        out = {
            "shards": g.shards,
            "capacity": g.capacity,
            "n_live": g.n_live,
            "refreshes": c.refreshes,
            "delta_refreshes": c.delta_refreshes,
            "n_clusters": g.n_clusters,
            "retries": c.retries,
            "quarantined_shards": c.quarantine_events,
            "quarantined_now": list(g.quarantined_now),
            "fenced_deltas": c.fenced_deltas,
            "degraded_queries": c.degraded_queries,
            "journal_entries": c.journal_entries,
            "query_chunks": c.query_chunks,
            "query_shards_scanned": c.query_shards_scanned,
            "query_shards_possible": c.query_chunks * g.shards,
            "snapshots_published": c.snapshots_published,
            "snapshot_version": g.snapshot_version,
            "snapshot_epoch": g.snapshot_epoch,
            "queries_served": c.queries_served,
            "query_launches": c.query_launches,
            "coalesced_requests": c.coalesced_requests,
            "query_rows": c.query_rows,
            "deadline_misses": c.deadline_misses,
            "queue_pending": g.queue_pending,
            "jit_cache_entries": g.jit_cache_entries,
            "oldest_ts": g.oldest_ts,
            "newest_ts": g.newest_ts,
            "refits": c.refits,
        }
        if nest_comm and self.comm:
            out["comm"] = dict(self.comm)
        return out

    def comm_dict(self) -> dict:
        """The backend-``comm_stats()``-shaped flat dict: backend tag +
        service stats + the meter snapshot flattened alongside."""
        return {"backend": self.backend} | self.as_dict(nest_comm=False) \
            | dict(self.comm)


# ---------------------------------------------------------------------------
# The query tier
# ---------------------------------------------------------------------------


class QueueFull(RuntimeError):
    """The bounded request queue refused a submit (backpressure)."""


@dataclasses.dataclass
class PendingQuery:
    """One enqueued request; ``result`` is filled by the next drain."""

    points: np.ndarray
    deadline: Optional[float]       # absolute time.monotonic() cutoff
    submitted: float
    result: Optional[QueryResult] = None


class QueryTier:
    """Pipelined read loop over a snapshot source (DESIGN.md §12).

    ``source`` is any object with ``snapshot()`` (last published view or
    None), ``read_snapshot()`` (freshness-seeking: fold pending writes,
    then return the published view), and optionally ``quarantined``
    (shard→reason of CURRENTLY quarantined shards) — the facade's batch
    backends qualify.

    Freshness policy (``max_staleness`` seconds):

    * ``None`` (default) — always fresh: every drain goes through
      ``read_snapshot()``, folding pending writes first.  This is the
      legacy read semantics, and what the facade uses by default.
    * a float — serve the published snapshot as long as it is at most
      that old; only refresh when the bound is exceeded (or no snapshot
      exists yet).  ``float('inf')``: never refresh — the pure
      decoupled read path.
    """

    def __init__(self, source, *, max_queries: int = 256,
                 queue_depth: int = 64, bucket_min: int = 16,
                 max_staleness: Optional[float] = None):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if bucket_min < 1:
            raise ValueError(f"bucket_min must be >= 1, got {bucket_min}")
        self.source = source
        self.max_queries = int(max_queries)
        self.queue_depth = int(queue_depth)
        self.bucket_min = min(int(bucket_min), self.max_queries)
        self.max_staleness = max_staleness
        self._pending: List[PendingQuery] = []
        self._gather_cache: dict = {}
        self._gather_version = 0
        # Monotonic tier counters (folded into ServiceStats).
        self.queries_served = 0
        self.query_launches = 0
        self.coalesced_requests = 0
        self.query_rows = 0
        self.deadline_misses = 0
        self.degraded_queries = 0
        self.last_version = 0

    # -- submission ---------------------------------------------------------

    def submit(self, points: np.ndarray,
               deadline: Optional[float] = None) -> PendingQuery:
        """Enqueue one request; raises ``QueueFull`` past ``queue_depth``.
        ``deadline`` is an absolute ``time.monotonic()`` cutoff; a
        request served after it is counted in ``deadline_misses`` (and
        still answered — from the snapshot, a stale answer beats none)."""
        if len(self._pending) >= self.queue_depth:
            raise QueueFull(
                f"query queue full ({self.queue_depth} pending); drain() "
                f"before submitting more")
        req = PendingQuery(
            points=np.asarray(points, np.float32).reshape(-1, 2),
            deadline=deadline, submitted=time.monotonic())
        self._pending.append(req)
        return req

    def query(self, points: np.ndarray,
              deadline: Optional[float] = None) -> QueryResult:
        """Synchronous convenience: submit + drain one request."""
        req = self.submit(points, deadline=deadline)
        self.drain()
        return req.result

    @property
    def pending(self) -> int:
        return len(self._pending)

    # -- snapshot resolution ------------------------------------------------

    def _resolve_snapshot(self) -> Optional[Snapshot]:
        snap = self.source.snapshot()
        if snap is None:
            return self.source.read_snapshot()
        if self.max_staleness is None:
            return self.source.read_snapshot()
        if snap.age() > self.max_staleness:
            return self.source.read_snapshot()
        return snap

    # -- the drain: route, coalesce, bucket, launch, split ------------------

    def drain(self) -> List[QueryResult]:
        """Answer every pending request from one resolved snapshot.
        Requests whose ε-dilated scan sets overlap share a query
        launch; all shapes are pow2-bucketed.  Returns results in
        submission order (also filled into each ``PendingQuery``)."""
        reqs, self._pending = self._pending, []
        if not reqs:
            return []
        snap = self._resolve_snapshot()
        now = time.monotonic()
        quarantined_now = frozenset(
            dict(getattr(self.source, "quarantined", {}) or {}))

        if snap is None:
            # Empty service, never refreshed: the all-noise short-circuit
            # (same as the engines' sync path), version 0.
            for req in reqs:
                req.result = QueryResult(
                    np.full((len(req.points),), -1, np.int32), version=0,
                    latency_ms=(now - req.submitted) * 1e3)
            self._finish(reqs, now)
            return [r.result for r in reqs]

        if snap.version != self._gather_version:
            self._gather_cache.clear()
            self._gather_version = snap.version

        routes = [route_snapshot(snap, req.points, quarantined_now)
                  for req in reqs]
        groups = self._coalesce([scan for scan, _ in routes])
        for group in groups:
            self._launch_group(snap, [reqs[i] for i in group],
                               [routes[i] for i in group])
        now = time.monotonic()
        for req, (scan, degraded) in zip(reqs, routes):
            req.result.latency_ms = (now - req.submitted) * 1e3
            if degraded:
                self.degraded_queries += 1
        self.last_version = snap.version
        self._finish(reqs, now)
        return [r.result for r in reqs]

    def _finish(self, reqs: List[PendingQuery], now: float) -> None:
        self.queries_served += len(reqs)
        for req in reqs:
            if req.deadline is not None and now > req.deadline:
                self.deadline_misses += 1

    def _coalesce(self, scans: List[np.ndarray]) -> List[List[int]]:
        """Group request indices whose scan sets overlap (transitively):
        each group becomes one batched launch over the union scan set.
        Requests with empty scan sets stay singleton (they short-circuit
        to noise without a launch)."""
        parent = list(range(len(scans)))

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        for i in range(len(scans)):
            if not scans[i].any():
                continue
            for j in range(i + 1, len(scans)):
                if (scans[i] & scans[j]).any():
                    ri, rj = find(i), find(j)
                    if ri != rj:
                        parent[rj] = ri
        groups: dict = {}
        for i in range(len(scans)):
            groups.setdefault(find(i), []).append(i)
        return list(groups.values())

    def _launch_group(self, snap: Snapshot, reqs: List[PendingQuery],
                      routes: List[Tuple[np.ndarray, bool]]) -> None:
        union = np.zeros((snap.shards,), bool)
        for scan, _ in routes:
            union |= scan
        sel = np.nonzero(union)[0]
        if len(sel) == 0:
            for req, (scan, degraded) in zip(reqs, routes):
                req.result = QueryResult(
                    np.full((len(req.points),), -1, np.int32),
                    version=snap.version, degraded=degraded)
            return
        rows = np.concatenate([req.points for req in reqs])
        labels = np.empty((len(rows),), np.int32)
        pts, mask, glab = self._gather(snap, sel)
        qmax = self.max_queries
        for off in range(0, len(rows), qmax):
            chunk = rows[off:off + qmax]
            nq = len(chunk)
            width = pow2_bucket(nq, self.bucket_min, qmax)
            if nq < width:
                chunk = np.pad(chunk, ((0, width - nq), (0, 0)))
            q = torch.as_tensor(np.ascontiguousarray(chunk, np.float32),
                                device=pts.device)
            out = _snapshot_query(q, pts, mask, glab, snap.eps)
            labels[off:off + nq] = out[:nq].cpu().numpy()
            self.query_launches += 1
            self.query_rows += width
        if len(reqs) > 1:
            self.coalesced_requests += len(reqs)
        base = 0
        for req, (scan, degraded) in zip(reqs, routes):
            n = len(req.points)
            req.result = QueryResult(
                labels[base:base + n], version=snap.version,
                degraded=degraded,
                scanned_shards=tuple(np.nonzero(scan)[0].tolist()))
            base += n

    def _gather(self, snap: Snapshot, sel: np.ndarray):
        """Stack the scanned shards' snapshot rows, padded to a pow2
        shard width (padded rows point at shard 0 with a zeroed mask —
        inert, as the reference's).  Scanned shards stay in ascending
        order, then slots: the argmin's tie-break depends on it.  Cached
        per (snapshot version, scan set), bounded."""
        key = tuple(int(s) for s in sel)
        hit = self._gather_cache.get(key)
        if hit is None:
            spad = 1 << max(0, (len(sel) - 1).bit_length())
            pad = np.concatenate([sel, np.zeros((spad - len(sel),), np.int64)])
            dev = snap.pts.device
            rows = torch.as_tensor(pad, device=dev)
            valid = torch.arange(spad, device=dev) < len(sel)
            pts = snap.pts.index_select(0, rows)
            mask = snap.mask.index_select(0, rows) & valid[:, None]
            glab = snap.glabels.index_select(0, rows)
            if len(self._gather_cache) > 16:
                self._gather_cache.clear()
            hit = (pts, mask, glab)
            self._gather_cache[key] = hit
        return hit

    # -- stats --------------------------------------------------------------

    def counters(self) -> dict:
        return {
            "queries_served": self.queries_served,
            "query_launches": self.query_launches,
            "coalesced_requests": self.coalesced_requests,
            "query_rows": self.query_rows,
            "deadline_misses": self.deadline_misses,
            "degraded_queries": self.degraded_queries,
        }

    def cache_bound(self, shards: int) -> int:
        """Worst-case launch-shape count for this tier's traffic: one
        entry per (pow2 query bucket, pow2 scanned-shard width) pair."""
        qb = 0
        w = self.bucket_min
        while True:
            qb += 1
            if w >= self.max_queries:
                break
            w = min(w * 2, self.max_queries)
        sb = max(1, shards - 1).bit_length() + 1
        return qb * sb
