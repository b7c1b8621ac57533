"""Pluggable execution backends behind the ``repro_torch.ddc.DDC`` facade.

Counterpart of the reference package's ``ddc/backends.py``.  A
``Backend`` executes the paper's two-phase pipeline for one deployment
style; the facade is backend-agnostic, so switching between the host
oracle and the one-device pipeline is a config knob, not a caller
rewrite.

* ``host`` — wraps ``repro_torch.core.ddc.ddc_host`` (NumPy, exact
  polygon-overlap merge): the paper-faithful oracle.
* ``jit``  — wraps ``repro_torch.core.ddc.make_ddc_fn``: phase 1 per
  lane, the lanes one after another on the backend's device, then phase
  2 under the configured schedule (sync / async / tree), which gives the
  reference's collectives' result lane for lane.

* ``stream`` — wraps ``repro_torch.serve.cluster_service.ClusterService``:
  ring-buffer ingest, dirty-shard phase 1, exact delta merge, TTL
  eviction, the failure model and bit-identical snapshot/restore, its
  buffers on the backend's device; ``agg_degree`` swaps in the tree of
  aggregators and ``track=True`` the cluster tracker (``tracks()``).
* ``dist`` — wraps ``repro_torch.serve.dist_service.DistClusterService``:
  the ``stream`` engine's control plane with each shard's buffers and
  phase 1 on a lane of its own (a CUDA stream on a card), only the delta
  ClusterSets and slot-map rows crossing to the aggregator, metered from
  the bytes fetched.  Bit-identical to ``stream``; snapshots move between
  the two.

Both batch backends consume the same per-shard membership (the block
``np.array_split`` partition), so they produce the identical global
clustering (``repro_torch.core.ddc.same_clustering``).  They support
``partial_fit`` by buffering per-shard points and lazily re-running the
full pipeline on the next read.  Reads go through the query tier
(``repro_torch.serve.query_tier``) over a snapshot whose tensors lie on
the backend's device.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Type

import numpy as np
import torch

from repro_torch.core import ddc as core_ddc
from repro_torch.data import spatial
from repro_torch.ddc.config import ConfigError, DDCConfig
from repro_torch.serve import cluster_service
from repro_torch.serve import query_tier as qt

BACKENDS: Dict[str, Type["Backend"]] = {}


def register_backend(name: str):
    """Class decorator: make ``name`` constructible via ``DDCConfig``."""
    def deco(cls):
        cls.name = name
        BACKENDS[name] = cls
        return cls
    return deco


class Backend:
    """Execution-engine interface the facade drives (see module doc).

    ``device`` is where the backend's tensors live: the pipeline's lanes
    for ``jit`` and the published read snapshot for both.  ``faults`` (an
    optional ``repro_torch.serve.faults.FaultPlan``) arms the streaming
    engines' fault-injection seam; the batch backends accept and ignore
    it (they have no exchange to fault)."""

    name = "?"

    def __init__(self, cfg: DDCConfig,
                 meter: core_ddc.CommMeter | None = None,
                 faults=None, *, device="cuda"):
        self.cfg = cfg
        self.meter = meter or core_ddc.CommMeter()
        self.faults = faults
        self.device = torch.device(device)

    # write path
    def fit(self, points: np.ndarray, t: float | None = None) -> None:
        raise NotImplementedError

    def partial_fit(self, shard: int, batch: np.ndarray,
                    t: float | None = None) -> None:
        raise NotImplementedError

    def expire(self, t: float) -> int:
        raise ConfigError(
            f"TTL eviction needs a streaming backend ('stream' or "
            f"'dist'), not {self.name!r}")

    def tracks(self):
        """The last published ``TrackSnapshot`` (DESIGN.md §14)."""
        raise ConfigError(
            f"cluster tracking needs a streaming backend ('stream' or "
            f"'dist') with track=True, not {self.name!r}: tracking is a "
            f"fold over refresh generations, and the batch backends "
            f"have none")

    # read path
    def labels(self) -> np.ndarray:
        raise NotImplementedError

    def points(self) -> np.ndarray:
        raise NotImplementedError

    def query(self, points: np.ndarray, legacy: bool = False):
        """Label query points against the fitted clustering.  Returns a
        ``QueryResult`` (labels + snapshot version + degraded flag +
        routing + latency) that duck-types as the bare labels array;
        ``legacy=True`` returns the ndarray outright."""
        raise NotImplementedError

    # snapshot-versioned read path (DESIGN.md §12)
    def snapshot(self):
        """The last published immutable read view, or None."""
        raise NotImplementedError

    def read_snapshot(self):
        """Freshness-seeking read view: fold pending writes, then return
        the published snapshot (None for an empty model)."""
        raise NotImplementedError

    @property
    def quarantined(self) -> dict:
        """shard -> reason for currently quarantined shards ({} for the
        batch backends: they have no failure model)."""
        return {}

    @property
    def query_tier(self):
        """The backend's ``QueryTier``: the pipelined, coalescing,
        snapshot-serving read loop (built lazily from the config's
        queue_depth / query_bucket_min / max_staleness knobs)."""
        if getattr(self, "_tier", None) is None:
            self._tier = qt.QueryTier(
                self,
                max_queries=self.cfg.max_queries,
                queue_depth=self.cfg.queue_depth,
                bucket_min=self.cfg.query_bucket_min,
                max_staleness=self.cfg.max_staleness)
        return self._tier

    def service_stats(self):
        """The typed ``ServiceStats`` contract (counters vs gauges)."""
        raise NotImplementedError

    def comm_stats(self) -> dict:
        return {"backend": self.name} | self.meter.snapshot()

    # snapshot/restore
    def state(self) -> tuple[dict, dict]:
        """(arrays, manifest): everything needed to resume bit-identically."""
        raise NotImplementedError

    def load_state(self, arrays: dict, manifest: dict) -> None:
        raise NotImplementedError


class _BufferedBatchBackend(Backend):
    """Shared machinery for the batch backends: per-shard point buffers,
    lazy refit, block-partition bookkeeping."""

    def __init__(self, cfg: DDCConfig, meter=None, faults=None, *, device="cuda"):
        super().__init__(cfg, meter, faults=faults, device=device)
        self._shard_pts: List[np.ndarray] = [
            np.zeros((0, 2), np.float32) for _ in range(cfg.shards)]
        self._labels: Optional[np.ndarray] = None
        self._snapshot = None
        self._snapshot_version = 0
        self.refits = 0           # monotonic: full-pipeline recomputes

    def fit(self, points: np.ndarray, t: float | None = None) -> None:
        pts = np.asarray(points, np.float32).reshape(-1, 2)
        parts = np.array_split(np.arange(len(pts)), self.cfg.shards)
        self._shard_pts = [pts[idx] for idx in parts]
        self._labels = None
        self._snapshot = None

    def partial_fit(self, shard, batch, t=None) -> None:
        if not 0 <= shard < self.cfg.shards:
            raise ConfigError(f"shard {shard} out of range [0, {self.cfg.shards})")
        batch = np.asarray(batch, np.float32).reshape(-1, 2)
        self._shard_pts[shard] = np.concatenate([self._shard_pts[shard], batch])
        self._labels = None
        self._snapshot = None

    def points(self) -> np.ndarray:
        return (np.concatenate(self._shard_pts) if any(len(p) for p in self._shard_pts)
                else np.zeros((0, 2), np.float32))

    def parts(self) -> List[np.ndarray]:
        out, base = [], 0
        for p in self._shard_pts:
            out.append(np.arange(base, base + len(p)))
            base += len(p)
        return out

    def labels(self) -> np.ndarray:
        if self._labels is None:
            self._labels = self._refit()
            self.refits += 1
        return self._labels

    def query(self, points: np.ndarray, legacy: bool = False):
        """Label queries via the published snapshot: the first read after
        a write refits ONCE and publishes a snapshot; every further query
        is answered from it (the ``refits`` counter shows it)."""
        res = self.query_tier.query(points)
        return res.labels if legacy else res

    # -- snapshot publish --------------------------------------------------

    def snapshot(self):
        # A write since the last publish invalidates (fit/partial_fit
        # set _snapshot = None), so a held snapshot is never torn.
        return self._snapshot

    def read_snapshot(self):
        if not any(len(p) for p in self._shard_pts):
            return None
        if self._snapshot is None:
            self._publish_snapshot()
        return self._snapshot

    def _publish_snapshot(self):
        """Cut an immutable read view from the buffered shard points +
        (lazily recomputed) labels: pow2-padded (K, cap) buffers, global
        labels per slot, per-shard live bboxes — the reference's layout,
        as new tensors on the backend's device."""
        labels = self.labels()          # refits at most once per write
        k = self.cfg.shards
        lens = [len(p) for p in self._shard_pts]
        cap = max(16, 1 << (max(lens) - 1).bit_length())
        pts = np.zeros((k, cap, 2), np.float32)
        mask = np.zeros((k, cap), bool)
        glab = np.full((k, cap), -1, np.int32)
        bboxes = []
        base = 0
        for s, p in enumerate(self._shard_pts):
            pts[s, :len(p)] = p
            mask[s, :len(p)] = True
            glab[s, :len(p)] = labels[base:base + len(p)]
            base += len(p)
            bboxes.append(
                (float(p[:, 0].min()), float(p[:, 1].min()),
                 float(p[:, 0].max()), float(p[:, 1].max()))
                if len(p) else None)
        self._snapshot_version += 1
        self._snapshot = qt.Snapshot(
            version=self._snapshot_version,
            epoch=self.refits,
            published_at=time.monotonic(),
            eps=float(self.cfg.eps),
            pts=torch.tensor(pts, device=self.device),
            mask=torch.tensor(mask, device=self.device),
            glabels=torch.tensor(glab, device=self.device),
            bboxes=tuple(bboxes),
            quarantined=frozenset(),
            n_live=sum(lens),
            n_clusters=len(set(labels[labels >= 0].tolist())),
        )
        return self._snapshot

    def service_stats(self):
        tier = getattr(self, "_tier", None)
        tc = tier.counters() if tier is not None else {}
        labels = self.labels() if any(len(p) for p in self._shard_pts) \
            else np.zeros((0,), np.int32)
        counters = qt.ServiceCounters(
            refreshes=self.refits,
            refits=self.refits,
            snapshots_published=self._snapshot_version,
            queries_served=tc.get("queries_served", 0),
            query_launches=tc.get("query_launches", 0),
            coalesced_requests=tc.get("coalesced_requests", 0),
            query_rows=tc.get("query_rows", 0),
            deadline_misses=tc.get("deadline_misses", 0),
            degraded_queries=tc.get("degraded_queries", 0),
        )
        gauges = qt.ServiceGauges(
            shards=self.cfg.shards,
            capacity=int(self._snapshot.pts.shape[1])
            if self._snapshot is not None else 0,
            n_live=sum(len(p) for p in self._shard_pts),
            n_clusters=len(set(labels[labels >= 0].tolist())),
            snapshot_version=self._snapshot_version,
            snapshot_epoch=self._snapshot.epoch
            if self._snapshot is not None else 0,
            queue_pending=tier.pending if tier is not None else 0,
            jit_cache_entries=qt.snapshot_query_cache_entries(),
        )
        return qt.ServiceStats(backend=self.name, counters=counters,
                               gauges=gauges, comm=self.meter.snapshot())

    def _refit(self) -> np.ndarray:
        raise NotImplementedError

    def comm_stats(self) -> dict:
        self.labels()     # the meter fills when the (lazy) pipeline runs
        return super().comm_stats()

    def state(self) -> tuple[dict, dict]:
        arrays = {f"shard_{s}": p for s, p in enumerate(self._shard_pts)}
        arrays["labels"] = self.labels()
        return arrays, {"n_shards": self.cfg.shards}

    def load_state(self, arrays, manifest) -> None:
        self._shard_pts = [np.asarray(arrays[f"shard_{s}"], np.float32)
                           for s in range(int(manifest["n_shards"]))]
        self._labels = np.asarray(arrays["labels"], np.int32)
        self._snapshot = None


@register_backend("host")
class HostBackend(_BufferedBatchBackend):
    """Paper-faithful NumPy reference: per-partition ``dbscan_ref`` +
    exact polygon-overlap union-find (``ddc_host``, grid contours).  The
    clustering runs on the host; the read snapshot and its queries on the
    backend's device."""

    def __init__(self, cfg: DDCConfig, meter=None, faults=None, *, device="cuda"):
        super().__init__(cfg, meter, faults=faults, device=device)
        self._exchanged = 0

    def _refit(self) -> np.ndarray:
        pts = self.points()
        parts = self.parts()
        if len(pts) == 0:
            return np.zeros((0,), np.int32)
        labels, _, exchanged = core_ddc.ddc_host(
            pts, len(parts), self.cfg.eps, self.cfg.min_pts,
            partition=parts, contour="grid")
        self._exchanged = int(exchanged)
        # Contour vertices are the only phase-2 traffic (the 1–2 % claim):
        # each crosses once as an (x, y) f32 pair.
        self.meter.add_collective(1, self._exchanged * 8)
        self.meter.add_merge(len(parts), self.cfg.max_clusters)
        return labels.astype(np.int32)

    def comm_stats(self) -> dict:
        return super().comm_stats() | {"contour_vertices": self._exchanged}

    def state(self) -> tuple[dict, dict]:
        arrays, manifest = super().state()
        # labels() ran inside super().state(), so the counter is current;
        # a restored model must report it without re-running the fit.
        return arrays, manifest | {"exchanged": self._exchanged}

    def load_state(self, arrays, manifest) -> None:
        super().load_state(arrays, manifest)
        self._exchanged = int(manifest.get("exchanged", 0))


@register_backend("jit")
class JitBackend(_BufferedBatchBackend):
    """The one-device pipeline (``make_ddc_fn``): phase 1 per lane with
    zero communication, then the configured schedule (sync all-gather /
    async butterfly / tree) for phase 2, the lanes in turn on the
    backend's device.

    Per-shard buffers are padded to a common power-of-two width so the
    lanes see exactly the block partition the other backends use; the
    padding mask keeps padded rows out of phase 1.  The padding is the
    reference's, so the labels equal its jit backend's bit for bit.

    ``last_trace`` holds the last refit's ``make_ddc_fn`` trace (per-lane
    results and paths, the stacked local ClusterSets, phase times) with
    the global ClusterSet under ``"gcs"``.
    """

    def __init__(self, cfg: DDCConfig, meter=None, faults=None, *, device="cuda"):
        super().__init__(cfg, meter, faults=faults, device=device)
        self._runners: dict = {}
        self.last_trace: dict | None = None

    def make_runner(self, n_points: int):
        """The pipeline entry point for ``n_points`` inputs ((n, 2) points
        + (n,) mask, split into ``shards`` equal lanes); ``n_points`` must
        be a multiple of ``shards``.  One card runs every lane in turn, so
        any shard count fits one device.

        The reference's meter counts while its pipeline traces, once per
        compiled width; so the meter here counts the first run of each
        runner only."""
        k = self.cfg.shards
        if n_points % k:
            raise ConfigError(f"n_points {n_points} not a multiple of shards {k}")
        key = n_points
        if key not in self._runners:
            if len(self._runners) >= 4:   # the reference keeps at most four
                self._runners.clear()     # compiled widths
            core = self.cfg.core()
            fns = [core_ddc.make_ddc_fn(core, k, device=self.device, meter=self.meter),
                   core_ddc.make_ddc_fn(core, k, device=self.device)]

            def run(points, mask, trace: dict | None = None):
                fn = fns[0]
                fns[0] = fns[-1]
                return fn(points, mask, trace)

            self._runners[key] = run
        return self._runners[key]

    def _refit(self) -> np.ndarray:
        k = self.cfg.shards
        lens = [len(p) for p in self._shard_pts]
        if sum(lens) == 0:
            return np.zeros((0,), np.int32)
        # Round the padded width up to a power of two (at least 16), as
        # the reference does to re-use one compiled program.
        cap = max(lens)
        cap = max(16, 1 << (cap - 1).bit_length())
        padded = np.zeros((k, cap, 2), np.float32)
        mask = np.zeros((k, cap), bool)
        for s, p in enumerate(self._shard_pts):
            padded[s, :len(p)] = p
            mask[s, :len(p)] = True
        run = self.make_runner(k * cap)
        trace: dict = {}
        glabels, gcs, _ = run(padded.reshape(k * cap, 2), mask.reshape(k * cap), trace)
        self.last_trace = trace | {"gcs": gcs}
        flat = glabels.cpu().numpy().reshape(k, cap)
        return np.concatenate(
            [flat[s, :n] for s, n in enumerate(lens)]).astype(np.int32)


@register_backend("stream")
class StreamBackend(Backend):
    """The online serve engine: ring-buffer ingest, dirty-shard phase 1,
    exact delta-merge, bbox-routed point queries, TTL eviction, and
    bit-identical snapshot/restore, its buffers on the backend's device.
    ``fit`` streams the batch in; ``partial_fit`` is the native write
    path."""

    def __init__(self, cfg: DDCConfig, meter=None, faults=None, *, device="cuda"):
        super().__init__(cfg, meter, faults=faults, device=device)
        self._svc: Optional[cluster_service.ClusterService] = None

    @property
    def service(self) -> cluster_service.ClusterService:
        """The underlying service engine (built lazily: the ring capacity
        may be sized by the first ``fit``)."""
        if self._svc is None:
            if self.cfg.capacity is None:
                raise ConfigError(
                    f"backend={self.name!r} with partial_fit before fit "
                    f"needs an explicit capacity in DDCConfig (fit() would "
                    f"size it from the batch)")
            self._svc = self._build(self.cfg.capacity)
        return self._svc

    def _stream_config(self, capacity: int) -> cluster_service.StreamConfig:
        cfg = self.cfg
        return cluster_service.StreamConfig(
            shards=cfg.shards, capacity=capacity,
            max_batch=min(cfg.max_batch, capacity),
            max_queries=cfg.max_queries,
            merge_mode=cfg.merge_mode,
            max_retries=cfg.max_retries,
            retry_backoff=cfg.retry_backoff,
            journal_limit=cfg.journal_limit,
            agg_degree=cfg.agg_degree,
            track=cfg.track,
            track_history=cfg.track_history,
            match_min_overlap=cfg.match_min_overlap,
            ddc=cfg.core())

    @classmethod
    def _svc_cls(cls):
        return cluster_service.ClusterService

    def _build(self, capacity: int) -> cluster_service.ClusterService:
        return self._svc_cls()(self._stream_config(capacity), meter=self.meter,
                               faults=self.faults, device=self.device)

    def fit(self, points: np.ndarray, t: float | None = None) -> None:
        pts = np.asarray(points, np.float32).reshape(-1, 2)
        k = self.cfg.shards
        cap = self.cfg.capacity or spatial.shard_capacity(len(pts), k)
        self._svc = self._build(cap)
        batch = min(self.cfg.max_batch, cap)
        for shard, chunk in spatial.stream_batches(pts, k, batch):
            self._svc.ingest(shard, chunk, t=t)
        self._svc.refresh()

    def partial_fit(self, shard, batch, t=None) -> None:
        self.service.ingest(shard, batch, t=t)

    def expire(self, t: float) -> int:
        return sum(self.service.evict_older_than(s, t) for s in range(self.cfg.shards))

    def tracks(self):
        if not self.cfg.track:
            raise ConfigError(
                "cluster tracking is disabled for this model; construct "
                "with DDCConfig(track=True, backend='stream'|'dist') to "
                "assign stable track IDs at refresh")
        # Freshness-seeking like read_snapshot: fold pending writes so
        # the returned TrackSnapshot reflects everything ingested.
        self.service.read_snapshot()
        return self.service.track_snapshot()

    def labels(self) -> np.ndarray:
        return self.service.live()[2]

    def points(self) -> np.ndarray:
        return self.service.live()[0]

    def parts(self) -> List[np.ndarray]:
        return self.service.live()[1]

    def query(self, points: np.ndarray, legacy: bool = False):
        return self.service.query(points, legacy=legacy)

    # -- snapshot-versioned reads (delegate to the serve engine) -----------

    def snapshot(self):
        return self._svc.snapshot() if self._svc is not None else None

    def read_snapshot(self):
        if self._svc is None and self.cfg.capacity is None:
            return None          # nothing fitted, nothing to publish
        return self.service.read_snapshot()

    @property
    def quarantined(self) -> dict:
        return self._svc.quarantined if self._svc is not None else {}

    def service_stats(self):
        if self._svc is None:
            return qt.ServiceStats(
                backend=self.name, counters=qt.ServiceCounters(),
                gauges=qt.ServiceGauges(shards=self.cfg.shards),
                comm=self.meter.snapshot())
        return self.service.service_stats(tier=getattr(self, "_tier", None))

    def comm_stats(self) -> dict:
        if self._svc is None:
            return {"backend": self.name} | self.meter.snapshot()
        return self.service_stats().comm_dict()

    def state(self) -> tuple[dict, dict]:
        return self.service.state_dict()

    def load_state(self, arrays, manifest) -> None:
        cfg = self.cfg
        scfg = cluster_service.StreamConfig(
            shards=int(manifest["shards"]),
            capacity=int(manifest["capacity"]),
            max_batch=int(manifest["max_batch"]),
            max_queries=int(manifest["max_queries"]),
            merge_mode=manifest["merge_mode"],
            max_retries=int(manifest.get("max_retries", cfg.max_retries)),
            retry_backoff=float(manifest.get("retry_backoff", cfg.retry_backoff)),
            journal_limit=int(manifest.get("journal_limit", cfg.journal_limit)),
            agg_degree=manifest.get("agg_degree", cfg.agg_degree),
            track=bool(manifest.get("track", cfg.track)),
            track_history=int(manifest.get("track_history", cfg.track_history)),
            match_min_overlap=float(manifest.get("match_min_overlap",
                                                 cfg.match_min_overlap)),
            ddc=cfg.core())
        self._svc = self._svc_cls().from_state(
            scfg, arrays, manifest, meter=self.meter, faults=self.faults,
            device=self.device)


@register_backend("dist")
class DistBackend(StreamBackend):
    """The device-resident streaming engine: the ``stream`` control plane
    over lanes that hold each shard's ring buffers and run its phase 1
    (one CUDA stream a lane on a card).  Only delta ClusterSets (up) and
    slot-map rows (down) cross to the aggregator, so ``comm_stats()``
    reports the bytes fetched.  Bit-identical to ``stream`` (and ``host``)
    on the same call sequence; snapshots are interchangeable with the
    ``stream`` backend's.  One card holds any number of lanes."""

    @classmethod
    def _svc_cls(cls):
        from repro_torch.serve import dist_service
        return dist_service.DistClusterService
