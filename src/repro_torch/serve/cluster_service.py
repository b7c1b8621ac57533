"""Streaming DDC serve engine: incremental ingest, delta-merge, queries.

Counterpart of the reference package's ``serve/cluster_service.py``, with
its buffers on a torch device (a CUDA card by default, the CPU when the
caller asks for it).

The paper's two-phase split (local clustering, then contour-only
aggregation) is what makes an *online* clustering service cheap: when new
points land on one shard, only that shard's local clusters change, and
the global view is repaired by re-merging just the touched contours — no
bulk data exchange.  This module is that serving path, split into two
halves (DESIGN.md §10):

* **Control plane** (``ShardControlPlane``) — the host-mirror half: ring
  slot choice, liveness/ts/seq mirrors, eviction victim selection,
  dirty-shard tracking, per-shard live-point bbox mirrors (query
  routing), the failure model (journal, validation gate, epoch fence,
  quarantine, recovery) and snapshot publish.  Everything it decides is a
  pure function of the call sequence, and the host mirrors are
  authoritative, so the write path never reads the device back.
* **Data plane** (``ClusterService``) — K ring buffers on the device,
  written in place by index writes of host-chosen slots; ``refresh`` runs
  ``core.ddc.local_phase`` on the dirty shards and ``core.ddc.merge_delta``
  on the aggregator mirror.

Engine behaviour:

* **Ingest** — appending past capacity evicts the oldest points (ring
  overwrite); ``evict_oldest`` (by ingest sequence) and
  ``evict_older_than`` (TTL, by the per-point timestamps mirrored on the
  host) are the explicit eviction APIs.  Liveness holes are legal.
* **Dirty-shard phase 1** — ``refresh`` re-runs ``local_phase`` only on
  shards whose buffers changed; an emptied shard takes the cached
  ``empty_clusterset`` without touching the device.
* **Delta-merge phase 2** — the engine caches every shard's ClusterSet
  and the (K·C, K·C) slot×slot contour-distance matrix.  A delta refresh
  recomputes only the dirty shards' rows and columns (one dirty shard:
  ``update_pair_d2``, B5's rectangular form over its C rows; several:
  ``update_pair_d2_many``) and re-closes the merge; the first merge and a
  forced full re-merge rebuild the matrix with B5's square form.  The
  matrix is a pure per-slot-pair function of the contours, so the patch
  equals the rebuild bit for bit (DESIGN.md §8).
* **Queries** — nearest clustered live point within ``eps``, else noise,
  over the shards whose ε-dilated live bbox could hold a neighbour
  (``query_tier.bbox_route``); the distance is the query tier's
  (``query_tier.nearest_labels``).
* **Snapshot/restore** — ``state_dict``/``from_state`` serialise the ring
  buffers, host mirrors, per-shard ClusterSets and the pair-d2 cache in
  the reference's layout and dtypes, so a state saved by either package
  restores in the other; the global set, maps and labels are recomputed
  on restore.

Aliasing: the reference donates its ring buffers to jitted updates, so a
published snapshot keeps the old arrays.  Here the rings are written in
place, so a published snapshot holds copies (``torch.stack``), the global
labels are a new tensor on every refresh (never written into), and the
query stack cache is dropped on every write path (``_invalidate_reads``).

Communication model (``CommMeter``): a full re-merge ships all K
ClusterSets up (K·B bytes, B = ``DDCConfig.buffer_bytes()``), a delta
refresh only the dirty ones (|dirty|·B); both ship each shard its (C,)
slot-map row back down (K·C·4 bytes).

Aggregator topologies: with ``agg_degree`` unset the engine owns the
flat (K·C)² cache above; with ``agg_degree`` = D the flat cache stays
None and ``serve.hierarchy.AggregatorTree`` (a D-ary tree of small
delta-cached aggregators, DESIGN.md §13) folds the same mirror into the
same global set and slot maps.  With ``track=True`` every post-gate
refresh is folded into ``serve.tracking.ClusterTracker`` (stable track
IDs, lifecycle events, motion analytics, DESIGN.md §14), whose snapshot
is cut with the read view's version.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import ddc as core_ddc
from repro_torch.serve import faults as faults_mod
from repro_torch.serve import hierarchy
from repro_torch.serve import journal as journal_mod
from repro_torch.serve import query_tier as qt
from repro_torch.serve import tracking as tracking_mod

ClusterSet = core_ddc.ClusterSet


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Static configuration of the streaming engine: the reference's
    fields and defaults."""

    shards: int                     # K logical shards
    capacity: int                   # per-shard point-buffer slots
    max_batch: int = 256            # ingest chunk width
    max_queries: int = 256          # query chunk width
    merge_mode: str = "delta"       # "delta" | "full"
    max_retries: int = 2            # delta re-deliveries per refresh
    retry_backoff: float = 0.0      # seconds; doubles per retry round
    journal_limit: int = 1024       # per-shard WAL entries before compaction
    agg_degree: Optional[int] = None  # None: flat aggregator; >=2: tree fan-in
    track: bool = False             # cluster tracking fold (DESIGN.md §14)
    track_history: int = 16         # per-track motion-history ring length
    match_min_overlap: float = 0.0  # tighten the match gate, in [0, 1)
    ddc: core_ddc.DDCConfig = dataclasses.field(default_factory=core_ddc.DDCConfig)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ClusterService: device 'cuda' requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array as a new tensor on ``dev``.  To a card it goes from
    pinned memory without blocking the host, as the reference's
    ``device_put`` does not block it."""
    t = torch.from_numpy(np.require(a, requirements=("C", "W")))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.clone()


_host = core_ddc.host_copy


@functools.lru_cache(maxsize=None)
def _empty_cached(c: int, v: int, device: str) -> ClusterSet:
    return core_ddc.empty_clusterset(core_ddc.DDCConfig(max_clusters=c, max_verts=v),
                                     device=device)


def empty_clusterset(cfg: core_ddc.DDCConfig, device) -> ClusterSet:
    """The all-invalid ClusterSet for ``cfg``'s budgets, cached per (C, V,
    device) as the reference caches it: every emptied shard gets this one
    object.  Nothing writes into it (``_set_row`` copies from it)."""
    return _empty_cached(cfg.max_clusters, cfg.max_verts, str(torch.device(device)))


# ---------------------------------------------------------------------------
# Data-plane state updates (in place)
# ---------------------------------------------------------------------------


def _append(pts_buf: torch.Tensor, mask_buf: torch.Tensor, batch: torch.Tensor,
            idx: torch.Tensor) -> None:
    """Ring-buffer append: write the rows of ``batch`` into slots ``idx``
    and mark them live, in place.  The slots are chosen on the host
    mirrors (``_write_slots``); only the valid rows are passed (the
    reference drops its padded rows at index ``cap``)."""
    pts_buf[idx] = batch
    mask_buf[idx] = True


def _kill_mask(mask_buf: torch.Tensor, kill: torch.Tensor) -> None:
    """Clear the live bit of every slot marked in ``kill`` (cap,) bool."""
    mask_buf &= ~kill


def _set_row(stack: ClusterSet, row: ClusterSet, i: int) -> None:
    """stack[i] <- row for every leaf of a stacked ClusterSet (in place)."""
    for s, x in zip(stack, row):
        s[i] = x


def _global_labels(dense: torch.Tensor, mask: torch.Tensor,
                   maps: torch.Tensor) -> torch.Tensor:
    """(K, cap) dense local labels + (K, C) slot maps -> global labels, a
    new tensor."""
    slot = maps.gather(1, dense.clamp(min=0).long())
    return torch.where(mask & (dense >= 0), slot, -1).to(torch.int32)


def _query_labels(q: torch.Tensor, qn: int, pts: torch.Tensor, mask: torch.Tensor,
                  glabels: torch.Tensor, eps: float) -> torch.Tensor:
    """Nearest clustered live point within eps, else -1, for the first
    ``qn`` rows of ``q`` (Qmax, 2); the rest are -1.  ``pts``/``mask``/
    ``glabels`` carry a leading scanned-shard axis."""
    lab = qt.nearest_labels(q, pts, mask, glabels, eps)
    rows = torch.arange(q.shape[0], device=q.device)
    return torch.where(rows < qn, lab, -1)


def _cs_to_host(cs: ClusterSet) -> dict:
    """One shard's delta as the host-side wire payload the validation
    gate (and the fault seam) sees: float32, int32, int32, bool, bool."""
    return {f: _host(t) for f, t in zip(ClusterSet._fields, cs)}


# ---------------------------------------------------------------------------
# Control plane — the host-mirror half
# ---------------------------------------------------------------------------


class ShardControlPlane:
    """Host mirrors + write/evict/routing policy over K logical shards.

    Subclasses supply the data plane: ``_append_chunk``, ``_kill_device``,
    ``_restore_lane``, ``_read_view``, ``_query_sync``, ``_live_buffers``
    and ``_invalidate_reads``.  Everything else is shared host logic that
    never reads the device on the write path."""

    flavor = "base"

    def __init__(self, scfg: StreamConfig, meter: core_ddc.CommMeter | None = None,
                 faults: faults_mod.FaultPlan | None = None, *, device="cuda"):
        if scfg.merge_mode not in ("delta", "full"):
            raise ValueError(scfg.merge_mode)
        if scfg.capacity < scfg.max_batch:
            raise ValueError(
                f"capacity {scfg.capacity} < max_batch {scfg.max_batch}: an "
                f"append chunk could overwrite itself in the ring scatter")
        self.device = _device(device)
        self.scfg = scfg
        self.cfg = scfg.ddc
        self.meter = meter
        self.faults = faults
        k, cap = scfg.shards, scfg.capacity
        # Host mirrors of the ring state, known exactly from the call
        # sequence: ``_live`` is the authoritative liveness mirror, ``_ts``
        # and ``_seq`` stamp each slot with its ingest timestamp and global
        # ingest sequence number, ``_hpts`` mirrors the coordinates written
        # (the per-shard bbox without reading the device back).
        self._head = [0] * k
        self._count = [0] * k
        self._live = [np.zeros((cap,), bool) for _ in range(k)]
        self._ts = [np.full((cap,), -np.inf) for _ in range(k)]
        self._seq = [np.full((cap,), -1, np.int64) for _ in range(k)]
        self._hpts = [np.zeros((cap, 2), np.float32) for _ in range(k)]
        self._bbox: List[Optional[tuple]] = [None] * k
        self._next_seq = 0
        self._dirty = set(range(k))
        # Aggregator mirror: every shard's last exchanged ClusterSet
        # (stacked), the slot-distance matrix and the merged global state.
        empty = empty_clusterset(self.cfg, self.device)
        self._local: List[ClusterSet] = [empty] * k
        self._batch = ClusterSet(*(t[None].expand((k,) + t.shape).clone() for t in empty))
        self._pair_d2: Optional[torch.Tensor] = None
        self._global: Optional[ClusterSet] = None
        self._maps: Optional[torch.Tensor] = None
        # Hierarchical aggregation (DESIGN.md §13): with ``agg_degree``
        # set, the flat (K·C)² cache above stays None and the tree owns
        # one small per-node cache per D children instead.
        self._hier: Optional[hierarchy.AggregatorTree] = None
        if scfg.agg_degree is not None:
            self._hier = hierarchy.AggregatorTree(k, scfg.agg_degree, self.cfg, meter=meter,
                                                  device=self.device)
        self.refreshes = 0
        self.delta_refreshes = 0
        self.query_chunks = 0
        self.query_shards_scanned = 0
        # Failure model (DESIGN.md §11): the write-ahead journal, the
        # quarantine set, and per-shard epochs fencing duplicate deliveries.
        self._journal = journal_mod.Journal(k, cap, limit=scfg.journal_limit)
        self._quarantined: dict = {}    # shard -> reason
        self._epoch = [0] * k           # delta generation per shard
        self._merged_epoch = [-1] * k   # last epoch folded into the merge
        self.retries = 0
        self.quarantine_events = 0
        self.fenced_deltas = 0
        self.degraded_queries = 0
        self.last_query_degraded = False
        self._route_degraded = False
        # Snapshot publish/swap (DESIGN.md §12): cut at the end of every
        # refresh (and restore), never invalidated by ingest/evict.
        self._snapshot: Optional[qt.Snapshot] = None
        self._snapshot_version = 0
        # Cluster tracking (DESIGN.md §14): a pure fold over the merged
        # generations, observed at refresh (post-gate only, so faulted
        # and fault-free runs fold identical inputs).
        self._tracker: Optional[tracking_mod.ClusterTracker] = None
        self._track_snapshot: Optional[tracking_mod.TrackSnapshot] = None
        if scfg.track:
            self._tracker = tracking_mod.ClusterTracker(
                self.cfg, history=scfg.track_history, min_overlap=scfg.match_min_overlap)

    # -- data-plane hooks ---------------------------------------------------

    def _append_chunk(self, shard: int, chunk: np.ndarray, idx: np.ndarray) -> None:
        raise NotImplementedError

    def _kill_device(self, shard: int, kill: np.ndarray) -> None:
        raise NotImplementedError

    def _restore_lane(self, shard: int, pts: np.ndarray, live: np.ndarray) -> None:
        """Overwrite one shard's device buffers wholesale (the recovery
        upload: journal-replayed points + live mask)."""
        raise NotImplementedError

    def _lose_lane(self, shard: int) -> None:
        """Model a dead lane: its device buffers are gone (zeroed), only
        the host mirrors + journal survive."""
        cap = self.scfg.capacity
        self._restore_lane(shard, np.zeros((cap, 2), np.float32), np.zeros((cap,), bool))
        self._invalidate_reads()

    def _invalidate_reads(self) -> None:
        """Called whenever a write/evict changes the live point set."""

    # -- write path ---------------------------------------------------------

    def _check_shard(self, shard: int) -> int:
        if not 0 <= shard < self.scfg.shards:
            raise ValueError(
                f"shard {shard} out of range [0, {self.scfg.shards}) for "
                f"this {self.scfg.shards}-shard service")
        return shard

    def ingest(self, shard: int, points: np.ndarray,
               t: float | np.ndarray | None = None) -> None:
        """Append ``points`` (n, 2) to ``shard``'s buffer, evicting the
        oldest live points if the buffer would overflow.

        ``t`` stamps the batch for TTL eviction: a scalar or an (n,)
        array.  Default: the global ingest sequence number."""
        self._check_shard(shard)
        cap, bmax = self.scfg.capacity, self.scfg.max_batch
        pts = np.asarray(points, np.float32).reshape(-1, 2)
        n = len(pts)
        if t is None:
            ts = np.arange(self._next_seq, self._next_seq + n, dtype=np.float64)
        else:
            ts = np.broadcast_to(np.asarray(t, np.float64), (n,))
        for off in range(0, n, bmax):
            chunk = pts[off:off + bmax]
            nb = len(chunk)
            idx = self._write_slots(shard, nb)
            seqs = np.arange(self._next_seq + off, self._next_seq + off + nb)
            # Write-ahead: journal the decision before the device write.
            self._journal.record_ingest(shard, idx, chunk, ts[off:off + nb], seqs)
            if shard not in self._quarantined:
                self._append_chunk(shard, chunk, idx)
            self._live[shard][idx] = True
            self._hpts[shard][idx] = chunk
            self._ts[shard][idx] = ts[off:off + nb]
            self._seq[shard][idx] = seqs
            self._head[shard] = int(idx[-1] + 1) % cap
            self._count[shard] = int(self._live[shard].sum())
        if self._journal.needs_compaction(shard):
            self._journal.compact(shard, self._hpts[shard], self._live[shard],
                                  self._ts[shard], self._seq[shard])
        self._next_seq += n
        if n and shard not in self._quarantined:
            self._dirty.add(shard)
        if n:
            self._bbox[shard] = None
            self._invalidate_reads()

    def _write_slots(self, shard: int, nb: int) -> np.ndarray:
        """The ``nb`` slots the next append chunk writes: dead slots in
        ring order from the head first, then — only when the buffer is
        full — the oldest live points by ingest sequence."""
        cap = self.scfg.capacity
        live = self._live[shard]
        order = (self._head[shard] + np.arange(cap)) % cap
        dead = order[~live[order]]
        take = dead[:nb]
        if len(take) < nb:
            live_idx = np.nonzero(live)[0]
            oldest = live_idx[np.argsort(self._seq[shard][live_idx], kind="stable")]
            take = np.concatenate([take, oldest[:nb - len(take)]])
        return take.astype(np.int64)

    def _apply_kill(self, shard: int, kill: np.ndarray) -> int:
        """Clear the live bits marked in ``kill`` (cap,) bool on the
        device and in the host mirrors.  Returns the number evicted."""
        self._check_shard(shard)
        n = int(kill.sum())
        if n == 0:
            return 0
        self._journal.record_kill(shard, kill)
        if shard not in self._quarantined:
            self._kill_device(shard, kill)
            self._dirty.add(shard)
        self._live[shard][kill] = False
        self._count[shard] = int(self._live[shard].sum())
        if self._journal.needs_compaction(shard):
            self._journal.compact(shard, self._hpts[shard], self._live[shard],
                                  self._ts[shard], self._seq[shard])
        self._bbox[shard] = None
        self._invalidate_reads()
        return n

    def evict_oldest(self, shard: int, n: int) -> int:
        """Evict the ``n`` oldest live points from ``shard`` (by ingest
        sequence).  Returns the number actually evicted."""
        self._check_shard(shard)
        live_idx = np.nonzero(self._live[shard])[0]
        if n <= 0 or len(live_idx) == 0:
            return 0
        order = np.argsort(self._seq[shard][live_idx], kind="stable")
        kill = np.zeros((self.scfg.capacity,), bool)
        kill[live_idx[order[:n]]] = True
        return self._apply_kill(shard, kill)

    def evict_older_than(self, shard: int, t: float) -> int:
        """TTL eviction: evict every live point on ``shard`` whose ingest
        timestamp is < ``t``.  Returns the eviction count."""
        self._check_shard(shard)
        return self._apply_kill(shard, self._live[shard] & (self._ts[shard] < t))

    def clear(self, shard: int) -> int:
        """Evict every live point from ``shard``."""
        self._check_shard(shard)
        return self._apply_kill(shard, self._live[shard].copy())

    def window_ts(self) -> Tuple[Optional[float], Optional[float]]:
        """(oldest, newest) live ingest timestamps across all shards;
        (None, None) when no point is live."""
        lo: Optional[float] = None
        hi: Optional[float] = None
        for s in range(self.scfg.shards):
            live = self._live[s]
            if not live.any():
                continue
            ts = self._ts[s][live]
            tmin, tmax = float(ts.min()), float(ts.max())
            lo = tmin if lo is None else min(lo, tmin)
            hi = tmax if hi is None else max(hi, tmax)
        return lo, hi

    # -- query routing ------------------------------------------------------

    def shard_bbox(self, shard: int) -> Optional[tuple]:
        """(x0, y0, x1, y1) over ``shard``'s live points, or None when
        the shard is empty, from the host coordinate mirror."""
        self._check_shard(shard)
        box = self._bbox[shard]
        if box is None:
            live = self._live[shard]
            if not live.any():
                box = ()
            else:
                p = self._hpts[shard][live]
                box = (float(p[:, 0].min()), float(p[:, 1].min()),
                       float(p[:, 0].max()), float(p[:, 1].max()))
            self._bbox[shard] = box
        return box or None

    def _route(self, q: np.ndarray) -> np.ndarray:
        """(K,) bool: shards whose ε-dilated live bbox could hold a
        neighbour of any row of ``q`` (``query_tier.bbox_route``, the
        snapshot path's test).  Quarantined shards are routed around and
        raise ``_route_degraded`` when they could have mattered."""
        k = self.scfg.shards
        scan = qt.bbox_route(tuple(self.shard_bbox(s) for s in range(k)), q, self.cfg.eps)
        self._route_degraded = False
        if self._quarantined:
            qmask = np.zeros((k,), bool)
            qmask[list(self._quarantined)] = True
            self._route_degraded = bool((scan & qmask).any())
            scan &= ~qmask
        self.query_chunks += 1
        self.query_shards_scanned += int(scan.sum())
        return scan

    # -- aggregator (delta merge + metering) --------------------------------

    def _merge_and_meter(self, dirty: list, mode: str, up_bytes: int | None = None) -> None:
        """Fold the aggregator mirror into the global state and account
        the up-leg: a delta refresh ships |dirty| ClusterSets, a full
        re-merge all K.  With ``up_bytes=None`` (the host-driven engine)
        the counters are that model; the ``dist`` engine passes the bytes
        it measured on its fetches from the lanes, metered as one
        collective.  The down-leg is ``_meter_maps_down``'s."""
        cfg = self.cfg
        k, c = self.scfg.shards, cfg.max_clusters
        bbytes = cfg.buffer_bytes()
        exclude = self._exclude_mask()

        def meter_up(links: int) -> None:
            if self.meter is not None:
                self.meter.add_collective(*((links, bbytes) if up_bytes is None
                                            else (1, up_bytes)))

        if self._hier is not None:
            # Hierarchical aggregation (DESIGN.md §13): shard payloads go
            # to their leaf aggregators; the tree meters its own internal
            # summary/map edges and folds, so only the shard→leaf up-leg
            # is accounted here.  The flat (K·C)² cache stays None.
            delta = mode == "delta" and self._hier.ready
            self._global, self._maps = self._hier.refresh(
                self._batch, dirty if delta else None, exclude)
            meter_up(len(dirty) if delta else k)
            if delta:
                self.delta_refreshes += 1
            return
        if mode == "delta" and self._pair_d2 is not None:
            self._global, self._maps, self._pair_d2 = core_ddc.merge_delta(
                self._batch, self._pair_d2, dirty, cfg, exclude)
            meter_up(len(dirty))
            self.delta_refreshes += 1
        else:
            self._global, self._maps, self._pair_d2 = core_ddc.merge_delta(
                self._batch, None, None, cfg, exclude)
            meter_up(k)
        if self.meter is not None:
            self.meter.add_merge(k, c)

    def _meter_maps_down(self, nbytes: int | None = None) -> None:
        """Account the down-leg: each shard's (C,) slot-map row, K·C·4
        bytes in the model; the ``dist`` engine passes the measured size
        of the maps it pushes, metered as one collective."""
        if self.meter is not None:
            if nbytes is None:
                self.meter.add_collective(self.scfg.shards, self.cfg.max_clusters * 4)
            else:
                self.meter.add_collective(1, nbytes)

    # -- delta exchange: fault seam, validation gate, retries, fencing ------

    def _exclude_mask(self) -> Optional[torch.Tensor]:
        """(K,) bool quarantine mask for ``merge_delta``/``merge_from_d2``
        (None when every shard is healthy)."""
        if not self._quarantined:
            return None
        mask = np.zeros((self.scfg.shards,), bool)
        mask[list(self._quarantined)] = True
        return _upload(mask, self.device)

    def _quarantine(self, shard: int, reason: str) -> None:
        """Fence ``shard`` out of merges and query routing.  Its cached
        pair-d2 rows and aggregator mirror stay untouched, so rejoining
        is one ordinary delta patch."""
        if shard not in self._quarantined:
            self._quarantined[shard] = reason
            self.quarantine_events += 1
        self._dirty.discard(shard)
        self._invalidate_reads()

    @property
    def quarantined(self) -> dict:
        """shard -> reason for every currently quarantined shard."""
        return dict(self._quarantined)

    def _fault_delta(self, shard: int, attempt: int,
                     payload: dict) -> Tuple[dict, bool]:
        """The fault-injection seam on the delta-exchange path: returns
        the (possibly mangled) payload plus a duplicate-delivery flag, or
        raises ``DeltaDropped`` / ``LaneKilled``."""
        if self.faults is None:
            return payload, False
        ev = self.faults.on_delta(shard, attempt)
        if ev is None:
            return payload, False
        if ev.kind in ("drop", "delay"):
            raise faults_mod.DeltaDropped(f"shard {shard} delta lost (attempt {attempt})")
        if ev.kind == "kill":
            raise faults_mod.LaneKilled(f"shard {shard} lane died")
        if ev.kind == "dup":
            return payload, True
        return self.faults.mangle(ev.kind, payload), False

    def _gate_and_stage(self, shard: int, payload: dict, epoch: int, cs=None) -> bool:
        """Epoch fence + validation gate in front of the aggregator
        mirror: a duplicate is discarded, a corrupt payload raises
        ``DeltaValidationError`` before any mirror or cached pair-d2 state
        is touched.  ``cs`` is the producer's ClusterSet for an unmangled
        payload (it keeps the cached empty ClusterSet's identity).
        Returns True iff the delta was staged."""
        if epoch <= self._merged_epoch[shard]:
            self.fenced_deltas += 1
            return False
        faults_mod.validate_delta(payload, self.cfg)
        if cs is None:     # the wire payload, rebuilt with no dtype change
            cs = core_ddc.clusterset_from_numpy(payload, device=self.device)
        self._local[shard] = cs
        _set_row(self._batch, cs, shard)
        self._merged_epoch[shard] = epoch
        return True

    def _exchange_deltas(self, dirty: list, produce) -> list:
        """One refresh's delta exchange: per-shard delivery with
        retry/backoff, the fault seam, the validation gate and the epoch
        fence.  ``produce(shard, attempt)`` yields ``(payload, cs)``.
        Shards whose deltas cannot be delivered or fail the gate are
        quarantined.  Returns the staged shard list."""
        staged: list = []
        pending = list(dirty)
        for i in pending:
            self._epoch[i] += 1
        attempt = 0
        while pending:
            if attempt > 0:
                self.retries += len(pending)
                if self.scfg.retry_backoff > 0:
                    time.sleep(self.scfg.retry_backoff * 2 ** (attempt - 1))
            still: list = []
            for i in pending:
                epoch = self._epoch[i]
                try:
                    sent, cs = produce(i, attempt)
                    payload, dup = self._fault_delta(i, attempt, sent)
                    if payload is not sent:
                        cs = None    # mangled in flight: trust the wire
                    if self._gate_and_stage(i, payload, epoch, cs):
                        staged.append(i)
                    if dup:
                        # a late duplicate of the delta just merged: the
                        # fence must discard it (exactly-once)
                        self._gate_and_stage(i, payload, epoch, cs)
                except faults_mod.DeltaDropped:
                    still.append(i)
                except faults_mod.LaneKilled:
                    self._lose_lane(i)
                    self._quarantine(i, "lane killed mid-refresh")
                except faults_mod.DeltaValidationError as e:
                    self._quarantine(i, f"delta rejected: {e}")
            if still and attempt >= self.scfg.max_retries:
                for i in still:
                    self._quarantine(i, f"delta dropped ({attempt + 1} attempts)")
                break
            pending = still
            attempt += 1
        return staged

    # -- recovery ------------------------------------------------------------

    def recover(self, shard: int) -> bool:
        """Rejoin a quarantined shard: replay the journal into the ring
        state the lane should hold, upload it, and mark the shard dirty.
        Returns True if the shard was quarantined (and is now rejoined);
        ``RecoveryError`` if the replay does not land on the mirrors."""
        self._check_shard(shard)
        if shard not in self._quarantined:
            return False
        pts, live, ts, seq = self._journal.replay(shard)
        if not (np.array_equal(pts, self._hpts[shard])
                and np.array_equal(live, self._live[shard])
                and np.array_equal(ts, self._ts[shard])
                and np.array_equal(seq, self._seq[shard])):
            raise faults_mod.RecoveryError(
                f"journal replay for shard {shard} diverged from the "
                f"host mirrors; refusing to rejoin")
        self._restore_lane(shard, pts, live)
        del self._quarantined[shard]
        self._dirty.add(shard)
        self._bbox[shard] = None
        self._invalidate_reads()
        return True

    def recover_all(self) -> list:
        """Rejoin every quarantined shard; returns the recovered list."""
        return [s for s in sorted(self._quarantined) if self.recover(s)]

    def refresh(self, mode: str | None = None, force: bool = False,
                track: bool | None = None):
        raise NotImplementedError

    # -- cluster tracking (DESIGN.md §14) -----------------------------------

    @property
    def tracker(self) -> Optional[tracking_mod.ClusterTracker]:
        return self._tracker

    def track_snapshot(self) -> Optional[tracking_mod.TrackSnapshot]:
        """The ``TrackSnapshot`` cut alongside the last published read
        view — same version, so labels+tracks reads are consistent.
        None before the first refresh or with tracking disabled."""
        return self._track_snapshot

    def _track_update(self, track: bool | None) -> None:
        """Fold the freshly merged generation into the tracker.

        ``track=None`` (the default) folds iff tracking is enabled and
        no shard is quarantined: the tracker observes only *post-gate*
        complete generations, so a faulted run and its fault-free twin
        fold identical inputs and their histories stay bit-identical.
        ``track=False`` skips the fold for this refresh; ``track=True``
        forces it."""
        if self._tracker is None or self._global is None:
            return
        if track is None:
            track = not self._quarantined
        if not track:
            return
        self._tracker.update(self._batch, self._maps, self._global)

    # -- snapshot publish/swap (DESIGN.md §12) ------------------------------

    def _read_view(self):
        """Data-plane hook for snapshot publish: (pts (K, cap, 2), mask
        (K, cap), glabels (K, cap)) that no later write changes."""
        raise NotImplementedError

    def _publish_snapshot(self) -> qt.Snapshot:
        """Cut and swap in a new immutable read view of the current
        engine state (end of every refresh, and restore)."""
        pts, mask, glab = self._read_view()
        k = self.scfg.shards
        self._snapshot_version += 1
        self._snapshot = qt.Snapshot(
            version=self._snapshot_version,
            epoch=self.refreshes,
            published_at=time.monotonic(),
            eps=float(self.cfg.eps),
            pts=pts, mask=mask, glabels=glab,
            bboxes=tuple(self.shard_bbox(s) for s in range(k)),
            quarantined=frozenset(self._quarantined),
            n_live=self.n_live(),
            n_clusters=self._n_clusters(),
        )
        if self._tracker is not None:
            # Same version as the labels snapshot above: a reader pairing
            # the two sees one consistent generation.
            self._track_snapshot = self._tracker.snapshot(
                version=self._snapshot_version, epoch=self.refreshes)
        return self._snapshot

    def _n_clusters(self) -> int:
        return int(self._global.valid.sum()) if self._global is not None else 0

    def snapshot(self) -> Optional[qt.Snapshot]:
        """The last published read view (None before the first refresh)."""
        return self._snapshot

    def read_snapshot(self) -> Optional[qt.Snapshot]:
        """Freshness-seeking read view: fold pending writes (refresh if
        dirty), then return the published snapshot.  None only for the
        empty service (nothing ingested, nothing merged)."""
        if self._global is None and self.n_live() == 0:
            return None
        if self._dirty or self._global is None:
            self.refresh()
        if self._snapshot is None:
            self._publish_snapshot()
        return self._snapshot

    # -- read path ----------------------------------------------------------

    def _query_sync(self, q: np.ndarray):
        """Engine hook: label ``q`` against the current refreshed state.
        Returns (labels (n,) int32, degraded, scanned-shard set)."""
        raise NotImplementedError

    def query(self, points: np.ndarray, return_stale: bool = False, legacy: bool = False):
        """Global cluster id for each query point: the label of the
        nearest clustered live point within ``eps``, else -1.  Returns a
        ``QueryResult`` (``legacy=True``: the bare labels array;
        ``return_stale=True``: a ``(result, degraded)`` tuple).  Pending
        writes are folded first; an empty service answers noise at
        version 0."""
        t0 = time.monotonic()
        q = np.asarray(points, np.float32).reshape(-1, 2)
        self.last_query_degraded = False
        if self._global is None and self.n_live() == 0:
            res = qt.QueryResult(np.full((len(q),), -1, np.int32), version=0,
                                 latency_ms=(time.monotonic() - t0) * 1e3)
            return self._query_return(res, return_stale, legacy)
        if self._dirty or self._global is None:
            self.refresh()
        out, degraded, scanned = self._query_sync(q)
        self.last_query_degraded = degraded
        if degraded:
            self.degraded_queries += 1
        res = qt.QueryResult(out, version=self._snapshot_version, degraded=degraded,
                             scanned_shards=tuple(sorted(scanned)),
                             latency_ms=(time.monotonic() - t0) * 1e3)
        return self._query_return(res, return_stale, legacy)

    @staticmethod
    def _query_return(res: qt.QueryResult, return_stale: bool, legacy: bool):
        out = res.labels if legacy else res
        return (out, res.degraded) if return_stale else out

    def service_stats(self, tier: qt.QueryTier | None = None) -> qt.ServiceStats:
        """The typed stats contract: monotonic counters, point-in-time
        gauges and the comm meter; ``tier`` folds a ``QueryTier``'s
        counters in."""
        tc = tier.counters() if tier is not None else {}
        counters = qt.ServiceCounters(
            refreshes=self.refreshes,
            delta_refreshes=self.delta_refreshes,
            snapshots_published=self._snapshot_version,
            query_chunks=self.query_chunks,
            query_shards_scanned=self.query_shards_scanned,
            queries_served=tc.get("queries_served", 0),
            query_launches=tc.get("query_launches", 0),
            coalesced_requests=tc.get("coalesced_requests", 0),
            query_rows=tc.get("query_rows", 0),
            deadline_misses=tc.get("deadline_misses", 0),
            degraded_queries=self.degraded_queries + tc.get("degraded_queries", 0),
            retries=self.retries,
            quarantine_events=self.quarantine_events,
            fenced_deltas=self.fenced_deltas,
            journal_entries=self._journal.entries_total,
        )
        oldest_ts, newest_ts = self.window_ts()
        gauges = qt.ServiceGauges(
            shards=self.scfg.shards,
            capacity=self.scfg.capacity,
            n_live=self.n_live(),
            oldest_ts=oldest_ts,
            newest_ts=newest_ts,
            n_clusters=self._n_clusters(),
            snapshot_version=self._snapshot_version,
            snapshot_epoch=self._snapshot.epoch if self._snapshot is not None else 0,
            quarantined_now=tuple(sorted(self._quarantined)),
            queue_pending=tier.pending if tier is not None else 0,
            jit_cache_entries=qt.snapshot_query_cache_entries(),
        )
        comm = self.meter.snapshot() if self.meter is not None else {}
        return qt.ServiceStats(backend=self.flavor, counters=counters, gauges=gauges,
                               comm=comm)

    def remerge_full(self):
        """Recompute the global state from scratch; bit-identical to the
        incrementally maintained state."""
        return self.refresh(mode="full", force=True)

    # -- snapshot helpers ---------------------------------------------------

    def _mirror_arrays(self) -> dict:
        """The control-plane mirrors + aggregator ClusterSet cache, as the
        NumPy dict ``state_dict`` builds on (the reference's keys and
        dtypes)."""
        arrays = {
            "live": np.stack(self._live),
            "ts": np.stack(self._ts),
            "seq": np.stack(self._seq),
            # The authoritative host point mirror: a quarantined lane's
            # device buffer is zeroed, and journal replay lands on this.
            "hpts": np.stack(self._hpts),
        }
        arrays |= {f"batch_{f}": _host(t) for f, t in zip(ClusterSet._fields, self._batch)}
        if self._pair_d2 is not None:
            arrays["pair_d2"] = _host(self._pair_d2)
        if self._tracker is not None:
            arrays.update(self._tracker.state_arrays())
        return arrays

    def _mirror_manifest(self) -> dict:
        return {
            "shards": self.scfg.shards,
            "capacity": self.scfg.capacity,
            "max_batch": self.scfg.max_batch,
            "max_queries": self.scfg.max_queries,
            "merge_mode": self.scfg.merge_mode,
            "agg_degree": self.scfg.agg_degree,
            "head": list(self._head),
            "count": list(self._count),
            "dirty": sorted(self._dirty),
            "next_seq": self._next_seq,
            "refreshes": self.refreshes,
            "delta_refreshes": self.delta_refreshes,
            "query_chunks": self.query_chunks,
            "query_shards_scanned": self.query_shards_scanned,
            "has_global": self._global is not None,
            "max_retries": self.scfg.max_retries,
            "retry_backoff": self.scfg.retry_backoff,
            "journal_limit": self.scfg.journal_limit,
            "epoch": list(self._epoch),
            "merged_epoch": list(self._merged_epoch),
            "quarantined": [[s, r] for s, r in sorted(self._quarantined.items())],
            "retries": self.retries,
            "quarantine_events": self.quarantine_events,
            "fenced_deltas": self.fenced_deltas,
            "degraded_queries": self.degraded_queries,
            "journal_entries": self._journal.entries_total,
            "snapshot_version": self._snapshot_version,
            "track": self.scfg.track,
            "track_history": self.scfg.track_history,
            "match_min_overlap": self.scfg.match_min_overlap,
            "tracker": self._tracker.state_manifest() if self._tracker is not None else None,
        }

    def _restore_mirrors(self, arrays: dict, manifest: dict) -> None:
        """Rebuild every host mirror from ``state_dict`` output."""
        k = self.scfg.shards
        self._live = [np.asarray(arrays["live"][i], bool).copy() for i in range(k)]
        self._ts = [np.asarray(arrays["ts"][i], np.float64).copy() for i in range(k)]
        self._seq = [np.asarray(arrays["seq"][i], np.int64).copy() for i in range(k)]
        hpts = arrays.get("hpts", arrays["pts"])
        self._hpts = [np.asarray(hpts[i], np.float32).copy() for i in range(k)]
        self._bbox = [None] * k
        self._head = [int(h) for h in manifest["head"]]
        self._count = [int(c) for c in manifest["count"]]
        self._next_seq = int(manifest["next_seq"])
        self._dirty = set(int(s) for s in manifest["dirty"])
        self.refreshes = int(manifest["refreshes"])
        self.delta_refreshes = int(manifest["delta_refreshes"])
        self.query_chunks = int(manifest.get("query_chunks", 0))
        self.query_shards_scanned = int(manifest.get("query_shards_scanned", 0))
        # The journal is not serialised: its base is re-set to the restored
        # mirrors, so a restored service can still quarantine and recover.
        self._epoch = [int(e) for e in manifest.get("epoch", [0] * k)]
        self._merged_epoch = [int(e) for e in manifest.get("merged_epoch", [-1] * k)]
        self._quarantined = {int(s): str(r) for s, r in manifest.get("quarantined", [])}
        self.retries = int(manifest.get("retries", 0))
        self.quarantine_events = int(manifest.get("quarantine_events", 0))
        self.fenced_deltas = int(manifest.get("fenced_deltas", 0))
        self.degraded_queries = int(manifest.get("degraded_queries", 0))
        # The restore publish continues from the saved version counter.
        self._snapshot_version = int(manifest.get("snapshot_version", 0))
        self._journal.entries_total = int(manifest.get("journal_entries", 0))
        for s in range(k):
            self._journal.compact(s, self._hpts[s], self._live[s], self._ts[s], self._seq[s])
        self._journal.compactions = 0
        # Tracker state (absent in snapshots without tracking -> fresh tracker).
        if self._tracker is not None and manifest.get("tracker") is not None:
            self._tracker.load_state(arrays, manifest["tracker"])

    def _restore_batch(self, arrays: dict) -> None:
        """Rebuild the aggregator ClusterSet mirror and the per-shard
        views from ``state_dict`` output."""
        k = self.scfg.shards
        self._batch = core_ddc.clusterset_from_numpy(
            {f: arrays[f"batch_{f}"] for f in ClusterSet._fields}, device=self.device)
        self._local = [ClusterSet(*(t[i].clone() for t in self._batch)) for i in range(k)]

    def _restore_global(self, arrays: dict, manifest: dict) -> bool:
        """Recompute the global set + slot maps after ``_restore_batch``.

        Flat mode replays the saved pair-d2 cache through
        ``merge_from_d2``; tree mode rebuilds every node cache from
        scratch over the restored batch — bit-identical to the saved tree
        by the per-node DESIGN §8 argument (delta-patched ≡ from-scratch),
        so nothing tree-shaped is serialised.  False when the saved
        engine had no global state yet."""
        if not manifest.get("has_global"):
            return False
        if self._hier is not None:
            self._global, self._maps = self._hier.refresh(self._batch, None,
                                                          self._exclude_mask())
            return True
        if "pair_d2" not in arrays:
            return False
        self._pair_d2 = _upload(np.asarray(arrays["pair_d2"], np.float32), self.device)
        self._global, self._maps = core_ddc.merge_from_d2(
            self._batch, self._pair_d2, self.cfg, self._exclude_mask())
        return True

    # -- introspection ------------------------------------------------------

    def n_live(self) -> int:
        return sum(self._count)

    def _live_buffers(self):
        """Data-plane hook for ``live()``: (pts (K, cap, 2), mask (K, cap),
        glabels (K, cap)) as NumPy arrays."""
        raise NotImplementedError

    def live(self) -> Tuple[np.ndarray, list, np.ndarray]:
        """(points (L, 2), parts, labels (L,)) of the live state, refreshed
        first: ``parts[s]`` indexes the rows held by shard ``s``, the
        explicit partition ``core.ddc.ddc_host`` accepts."""
        if self._dirty or self._global is None:
            self.refresh()
        pts, mask, glab = self._live_buffers()
        pts_rows, parts, labels = [], [], []
        base = 0
        for s in range(self.scfg.shards):
            msk = mask[s]
            pts_rows.append(pts[s][msk])
            labels.append(glab[s][msk])
            parts.append(np.arange(base, base + int(msk.sum())))
            base += int(msk.sum())
        return (np.concatenate(pts_rows) if base else np.zeros((0, 2), np.float32),
                parts,
                np.concatenate(labels) if base else np.zeros((0,), np.int32))

    def local_set(self, shard: int) -> ClusterSet:
        self._check_shard(shard)
        return self._local[shard]

    @property
    def pair_d2(self) -> Optional[torch.Tensor]:
        """A copy of the cached slot-distance matrix (the cache itself is
        patched in place by the next delta refresh)."""
        return None if self._pair_d2 is None else self._pair_d2.clone()

    @property
    def hierarchy(self) -> Optional[hierarchy.AggregatorTree]:
        """The aggregator tree (None in flat mode).  In tree mode
        ``pair_d2`` is None by construction — the per-node caches are the
        cache, reachable here for tests and the chaos sweep."""
        return self._hier

    @property
    def global_set(self) -> Optional[ClusterSet]:
        return self._global

    def routing_stats(self) -> dict:
        return {
            "query_chunks": self.query_chunks,
            "query_shards_scanned": self.query_shards_scanned,
            "query_shards_possible": self.query_chunks * self.scfg.shards,
        }

    def stats(self) -> dict:
        """Legacy dict view, derived from ``service_stats()``."""
        return self.service_stats().as_dict()


# ---------------------------------------------------------------------------
# The host-driven service
# ---------------------------------------------------------------------------


class ClusterService(ShardControlPlane):
    """Host-driven streaming DDC engine over K logical shards, its ring
    buffers on ``device`` (default the card; ``device="cpu"`` runs the
    kernels' plain versions).

    Write path: ``ingest(shard, points)`` appends into the shard's ring
    buffer and marks it dirty; ``refresh()`` re-clusters dirty shards and
    delta-merges them into the cached global state.  Read path:
    ``query(points)`` returns global cluster ids against the last
    refreshed state (refreshing first if writes are pending), scanning
    only bbox-routed candidate shards."""

    flavor = "stream"

    def __init__(self, scfg: StreamConfig, meter: core_ddc.CommMeter | None = None,
                 faults: faults_mod.FaultPlan | None = None, *, device="cuda"):
        super().__init__(scfg, meter, faults=faults, device=device)
        k, cap, dev = scfg.shards, scfg.capacity, self.device
        self._pts: List[torch.Tensor] = [
            torch.zeros((cap, 2), dtype=torch.float32, device=dev) for _ in range(k)]
        self._mask: List[torch.Tensor] = [
            torch.zeros((cap,), dtype=torch.bool, device=dev) for _ in range(k)]
        self._dense = torch.full((k, cap), -1, dtype=torch.int32, device=dev)
        self._glabels = torch.full((k, cap), -1, dtype=torch.int32, device=dev)
        self._stack_cache: dict = {}

    # -- data plane ---------------------------------------------------------

    def _append_chunk(self, shard, chunk, idx) -> None:
        _append(self._pts[shard], self._mask[shard], _upload(chunk, self.device),
                _upload(idx, self.device))

    def _kill_device(self, shard, kill) -> None:
        _kill_mask(self._mask[shard], _upload(kill, self.device))

    def _restore_lane(self, shard, pts, live) -> None:
        self._pts[shard] = _upload(np.asarray(pts, np.float32), self.device)
        self._mask[shard] = _upload(np.asarray(live, bool), self.device)

    def _invalidate_reads(self) -> None:
        self._stack_cache.clear()

    # -- refresh (phase 1 on dirty shards + delta/full merge) --------------

    def refresh(self, mode: str | None = None, force: bool = False,
                track: bool | None = None):
        """Re-cluster dirty shards and fold them into the global state.

        ``mode`` overrides the configured merge mode for this call;
        ``force`` recomputes even with no dirty shards; ``track`` is the
        per-call tracking override (``_track_update``).  Returns the
        global ClusterSet."""
        mode = mode or self.scfg.merge_mode
        cfg = self.cfg
        dirty = sorted(self._dirty - self._quarantined.keys())
        if not dirty and self._global is not None and not force:
            return self._global

        def produce(i, attempt):
            if self._count[i] == 0:
                # Emptied shard: the cached all-invalid ClusterSet, no
                # phase-1 work.
                cs = empty_clusterset(cfg, self.device)
                self._dense[i] = -1
            else:
                dense, cs = core_ddc.local_phase(self._pts[i], self._mask[i], cfg)
                self._dense[i] = dense
            return _cs_to_host(cs), cs

        staged = self._exchange_deltas(dirty, produce)
        self._merge_and_meter(staged, mode)
        self._meter_maps_down()
        self._glabels = _global_labels(self._dense, torch.stack(self._mask), self._maps)
        self._dirty -= set(staged)
        self._track_update(track)
        self.refreshes += 1
        self._publish_snapshot()
        return self._global

    # -- read path ---------------------------------------------------------

    def _read_view(self):
        # torch.stack copies the rings, which later writes change in
        # place; _glabels is replaced (never written into) by refresh.
        return torch.stack(self._pts), torch.stack(self._mask), self._glabels

    def _query_sync(self, q: np.ndarray):
        qmax = self.scfg.max_queries
        degraded = False
        scanned: set = set()
        out = np.empty((len(q),), np.int32)
        for off in range(0, len(q), qmax):
            chunk = q[off:off + qmax]
            nq = len(chunk)
            scan = self._route(chunk)
            degraded |= self._route_degraded
            sel = np.nonzero(scan)[0]
            scanned.update(int(s) for s in sel)
            if len(sel) == 0:
                out[off:off + nq] = -1
                continue
            pts, mask, rows = self._scan_stack(sel)
            glab = self._glabels.index_select(0, rows)
            if nq < qmax:
                chunk = np.pad(chunk, ((0, qmax - nq), (0, 0)))
            lab = _query_labels(_upload(chunk, self.device), nq, pts, mask, glab,
                                self.cfg.eps)
            out[off:off + nq] = lab[:nq].cpu().numpy()
        return out, degraded, scanned

    def _scan_stack(self, sel: np.ndarray):
        """Stack the scanned shards' buffers, padded to a power-of-two
        width as the reference pads them (padded rows point at shard 0
        with a zeroed mask).  Cached per scan set; every write path drops
        the cache (the stacks are copies of rings written in place)."""
        key = tuple(int(s) for s in sel)
        hit = self._stack_cache.get(key)
        if hit is None:
            spad = 1 << max(0, (len(sel) - 1).bit_length())
            pad = np.concatenate([sel, np.zeros((spad - len(sel),), np.int64)])
            valid = np.arange(spad) < len(sel)
            pts = torch.stack([self._pts[s] for s in pad])
            mask = torch.stack([self._mask[s] for s in pad]) \
                & _upload(valid, self.device)[:, None]
            if len(self._stack_cache) > 16:
                self._stack_cache.clear()
            hit = (pts, mask, _upload(pad, self.device))
            self._stack_cache[key] = hit
        return hit

    # -- introspection -----------------------------------------------------

    def _live_buffers(self):
        return (_host(torch.stack(self._pts)), _host(torch.stack(self._mask)),
                _host(self._glabels))

    # -- snapshot / restore -------------------------------------------------

    def state_dict(self) -> Tuple[dict, dict]:
        """The full engine state as (arrays, manifest), in the
        reference's layout: ring buffers, dense labels, host mirrors,
        per-shard ClusterSets and the pair-d2 cache.  The global set,
        slot maps and global labels are recomputed on restore."""
        arrays = {
            "pts": _host(torch.stack(self._pts)),
            "mask": _host(torch.stack(self._mask)),
            "dense": _host(self._dense),
        } | self._mirror_arrays()
        return arrays, self._mirror_manifest()

    @classmethod
    def from_state(cls, scfg: StreamConfig, arrays: dict, manifest: dict,
                   meter: core_ddc.CommMeter | None = None,
                   faults: faults_mod.FaultPlan | None = None, *,
                   device="cuda") -> "ClusterService":
        """Rebuild a service from ``state_dict`` output (of either
        package).  The restored engine resumes bit-identically: same
        labels, same cached pair-d2 matrix, same next refresh."""
        svc = cls(scfg, meter=meter, faults=faults, device=device)
        k, dev = scfg.shards, svc.device
        svc._pts = [_upload(np.asarray(arrays["pts"][i], np.float32), dev) for i in range(k)]
        svc._mask = [_upload(np.asarray(arrays["mask"][i], bool), dev) for i in range(k)]
        svc._dense = _upload(np.asarray(arrays["dense"], np.int32), dev)
        svc._restore_mirrors(arrays, manifest)
        svc._restore_batch(arrays)
        if svc._restore_global(arrays, manifest):
            svc._glabels = _global_labels(svc._dense, torch.stack(svc._mask), svc._maps)
            # Restore ends with an eager publish, like refresh does.
            svc._publish_snapshot()
        return svc
