"""Validated deployment configuration for the ``repro_torch.ddc`` facade.

Counterpart of the reference package's ``ddc/config.py``: the same
fields, defaults, rules and messages, so a snapshot manifest moves
between the two packages.  The device is not a field (``DDC`` takes it as
an argument): a field the reference lacks would make its
``DDCConfig.from_manifest`` refuse a snapshot of this package.

One config describes the *whole* deployment — the phase-1/phase-2 math
(mirroring ``repro_torch.core.ddc.DDCConfig``), the backend that executes it
(``host`` | ``jit`` | ``stream`` | ``dist``), and the streaming-engine
knobs.  The
point of the split from the core config is ``validate()``: every
backend/schedule compatibility rule and the DESIGN.md §7 sizing rule is
checked when the config is built, not discovered as a silent cluster
unmapping (or a trace-time assert) deep inside a distributed run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core import dbscan as dbscan_mod
from repro_torch.core import ddc as core_ddc
from repro_torch.core import geometry

SCHEDULES = ("sync", "async", "tree")
LOCAL_ALGOS = ("dbscan", "kmeans")
MERGE_MODES = ("delta", "full")


class ConfigError(ValueError):
    """A DDCConfig that cannot run correctly on its chosen backend."""


@dataclasses.dataclass(frozen=True)
class DDCConfig:
    """Estimator-facade configuration (hashable; see ``validate``).

    Clustering math (forwarded verbatim to ``repro_torch.core.ddc.DDCConfig``):
    ``eps``..``block_tile``.  Deployment: ``backend`` picks the execution
    engine, ``shards`` the partition width.  Streaming-only knobs
    (``capacity``..``merge_mode``) configure the serve engine and are
    ignored by the batch backends.
    """

    eps: float = 0.05
    min_pts: int = 5
    bounds: Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)
    grid: int = 128
    max_clusters: int = 32
    max_verts: int = 128
    merge_eps: Optional[float] = None
    local_algo: str = "dbscan"
    kmeans_k: int = 8
    schedule: str = "async"
    tree_degree: int = 2
    merge_refine: str = "grid"
    block_sparse: str = "auto"
    block_tile: int = 512

    backend: str = "host"
    shards: int = 4

    capacity: Optional[int] = None   # per-shard ring slots; None: sized at fit()
    max_batch: int = 256
    max_queries: int = 256
    merge_mode: str = "delta"
    max_retries: int = 2             # delta re-deliveries per refresh
    retry_backoff: float = 0.0       # seconds; doubles per retry round
    journal_limit: int = 1024        # per-shard WAL entries before compaction
    agg_degree: Optional[int] = None  # None: flat aggregator; >=2: the
    #                                  DESIGN §13 tree-of-aggregators fan-in

    # Cluster tracking knobs (DESIGN.md §14; stream/dist backends).
    track: bool = False              # fold stable track IDs at refresh
    track_history: int = 16          # per-track motion-history ring length
    match_min_overlap: float = 0.0   # tighten the match gate: d2 <=
    #                                  r²·(1-overlap), r = merge radius

    # Query-tier knobs (DESIGN.md §12; all backends).
    queue_depth: int = 64            # bounded request queue (backpressure)
    query_bucket_min: int = 16       # smallest pow2 query-width bucket
    max_staleness: Optional[float] = None   # seconds a snapshot may serve;
    #                                  None: always fresh (refresh-on-read),
    #                                  inf: never refresh (pure snapshot reads)

    _CORE_FIELDS = ("eps", "min_pts", "bounds", "grid", "max_clusters",
                    "max_verts", "merge_eps", "local_algo", "kmeans_k",
                    "schedule", "tree_degree", "merge_refine",
                    "block_sparse", "block_tile")

    def core(self) -> core_ddc.DDCConfig:
        """The core config this deployment config wraps."""
        kw = {f: getattr(self, f) for f in self._CORE_FIELDS}
        kw["bounds"] = tuple(kw["bounds"])
        return core_ddc.DDCConfig(**kw)

    def to_manifest(self) -> dict:
        """JSON-serialisable field dict (snapshot manifests)."""
        out = dataclasses.asdict(self)
        out["bounds"] = list(self.bounds)
        return out

    @classmethod
    def from_manifest(cls, doc: dict) -> "DDCConfig":
        kw = dict(doc)
        kw["bounds"] = tuple(kw["bounds"])
        return cls(**kw)

    # -- the validated-construction contract -------------------------------

    def validate(self, sample: np.ndarray | None = None) -> "DDCConfig":
        """Check every statically decidable correctness rule; returns self.

        Raises ``ConfigError`` on: malformed math parameters, an
        unregistered backend, a schedule the chosen backend cannot run
        (the async butterfly needs power-of-two shards), or streaming
        knobs that would corrupt the ring buffers.

        With ``sample`` (a representative (n, 2) point set) it also runs
        the DESIGN.md §7 sizing probe: sequential DBSCAN on the sample,
        then the occupancy-grid contour of every *global* (i.e. merged)
        cluster must fit ``max_verts``, and the global cluster count must
        fit ``max_clusters``.  This is the check that used to fail only
        as silently unmapped clusters inside ``match_to_global`` at
        runtime.
        """
        self._check_math()
        self._check_deployment()
        if sample is not None:
            self._check_sizing(np.asarray(sample, np.float64).reshape(-1, 2))
        return self

    def _check_math(self) -> None:
        x0, y0, x1, y1 = self.bounds
        if not (x1 > x0 and y1 > y0):
            raise ConfigError(f"degenerate bounds {self.bounds}")
        if not self.eps > 0:
            raise ConfigError(f"eps must be > 0, got {self.eps}")
        if self.merge_eps is not None and not self.merge_eps > 0:
            raise ConfigError(f"merge_eps must be > 0, got {self.merge_eps}")
        if self.min_pts < 1:
            raise ConfigError(f"min_pts must be >= 1, got {self.min_pts}")
        if self.grid < 2:
            raise ConfigError(f"grid must be >= 2, got {self.grid}")
        if self.max_clusters < 1 or self.max_verts < 4:
            raise ConfigError(
                f"cluster/vertex budgets too small: C={self.max_clusters}, "
                f"V={self.max_verts}")
        if self.local_algo not in LOCAL_ALGOS:
            raise ConfigError(f"unknown local_algo {self.local_algo!r}")
        if self.local_algo == "kmeans" and self.kmeans_k < 1:
            raise ConfigError(f"kmeans_k must be >= 1, got {self.kmeans_k}")
        if self.schedule not in SCHEDULES:
            raise ConfigError(
                f"unknown schedule {self.schedule!r}; pick one of {SCHEDULES}")
        if self.tree_degree < 2:
            raise ConfigError(f"tree_degree must be >= 2, got {self.tree_degree}")
        if self.merge_refine not in ("grid", "fps"):
            raise ConfigError(f"unknown merge_refine {self.merge_refine!r}")

    def _check_deployment(self) -> None:
        from repro_torch.ddc import backends   # late: backends imports this module

        if self.backend not in backends.BACKENDS:
            raise ConfigError(
                f"unknown backend {self.backend!r}; registered: "
                f"{sorted(backends.BACKENDS)}")
        if self.shards < 1:
            raise ConfigError(f"shards must be >= 1, got {self.shards}")
        if self.backend == "jit" and self.schedule == "async" \
                and self.shards & (self.shards - 1):
            raise ConfigError(
                f"the async butterfly schedule needs a power-of-two shard "
                f"count, got shards={self.shards}; use schedule='sync' or "
                f"'tree', or round shards to a power of two")
        # The reference also checks here that the dist backend's mesh holds
        # one device per shard.  The port's lanes are streams on one
        # device, which holds any number of them, so that rule has no
        # counterpart (ROADMAP C, a deviation the port accepts); the
        # engine refuses only a device that does not exist
        # (``serve.dist_service.require_devices``).
        if self.merge_mode not in MERGE_MODES:
            raise ConfigError(f"unknown merge_mode {self.merge_mode!r}")
        if self.max_batch < 1 or self.max_queries < 1:
            raise ConfigError(
                f"max_batch/max_queries must be >= 1, got "
                f"{self.max_batch}/{self.max_queries}")
        if self.capacity is not None and self.capacity < self.max_batch:
            raise ConfigError(
                f"capacity {self.capacity} < max_batch {self.max_batch}: an "
                f"append chunk could overwrite itself in the ring scatter")
        if self.max_retries < 0:
            raise ConfigError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.retry_backoff < 0:
            raise ConfigError(
                f"retry_backoff must be >= 0, got {self.retry_backoff}")
        if self.journal_limit < 1:
            raise ConfigError(
                f"journal_limit must be >= 1, got {self.journal_limit}")
        if self.agg_degree is not None:
            if self.backend not in ("stream", "dist"):
                raise ConfigError(
                    f"agg_degree (the hierarchical aggregator tree, DESIGN "
                    f"§13) only applies to the serving backends, got "
                    f"backend={self.backend!r}; batch backends use "
                    f"schedule='tree' + tree_degree instead")
            if self.agg_degree < 2:
                raise ConfigError(
                    f"agg_degree must be >= 2 (a degree-1 tree is an "
                    f"infinite chain of no-op folds), got {self.agg_degree}")
            if self.agg_degree & (self.agg_degree - 1):
                raise ConfigError(
                    f"agg_degree must be a power of two, got "
                    f"{self.agg_degree}: node caches patch dirty child rows "
                    f"through pow2-padded updates, and a pow2 fan-in keeps "
                    f"every level's jit compilation count bounded")
        if self.track and self.backend not in ("stream", "dist"):
            raise ConfigError(
                f"track=True (the cluster tracking subsystem, DESIGN §14) "
                f"needs a streaming backend ('stream' or 'dist'), got "
                f"backend={self.backend!r}: tracking is a fold over refresh "
                f"generations, and the batch backends have none")
        if self.track_history < 2:
            raise ConfigError(
                f"track_history must be >= 2 (velocity needs two history "
                f"samples), got {self.track_history}")
        if not 0.0 <= self.match_min_overlap < 1.0:
            raise ConfigError(
                f"match_min_overlap must be in [0, 1) (1 would demand "
                f"exactly-zero contour distance), got "
                f"{self.match_min_overlap}")
        if self.queue_depth < 1:
            raise ConfigError(
                f"queue_depth must be >= 1, got {self.queue_depth}")
        if self.query_bucket_min < 1 \
                or self.query_bucket_min > self.max_queries:
            raise ConfigError(
                f"query_bucket_min must be in [1, max_queries="
                f"{self.max_queries}], got {self.query_bucket_min}")
        if self.query_bucket_min & (self.query_bucket_min - 1):
            raise ConfigError(
                f"query_bucket_min must be a power of two (it is the "
                f"smallest jit shape bucket), got {self.query_bucket_min}")
        if self.max_staleness is not None and self.max_staleness < 0:
            raise ConfigError(
                f"max_staleness must be >= 0 (or None for always-fresh), "
                f"got {self.max_staleness}")

    def _check_sizing(self, sample: np.ndarray) -> None:
        labels = dbscan_mod.dbscan_ref(sample, self.eps, self.min_pts)
        ids = sorted(set(labels[labels >= 0].tolist()))
        if len(ids) > self.max_clusters:
            raise ConfigError(
                f"sizing probe: the sample holds {len(ids)} global clusters "
                f"but max_clusters={self.max_clusters}; the merge would "
                f"overflow the slot budget (DESIGN.md §7)")
        for cid in ids:
            occ = len(geometry.grid_contour_np(
                sample[labels == cid], tuple(self.bounds), self.grid))
            if occ > self.max_verts:
                raise ConfigError(
                    f"sizing probe: the merged contour of cluster {cid} "
                    f"occupies {occ} boundary cells at grid={self.grid} but "
                    f"max_verts={self.max_verts}; a truncated global outline "
                    f"silently unmaps distant fragments in match_to_global "
                    f"(DESIGN.md §7) — raise max_verts or coarsen grid")
