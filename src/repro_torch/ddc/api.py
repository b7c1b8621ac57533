"""``repro_torch.ddc.DDC`` — the estimator-style front door, on a CUDA
card (or the CPU when the caller asks for it).

Counterpart of the reference package's ``ddc/api.py``::

    from repro_torch.ddc import DDC, DDCConfig

    cfg = DDCConfig(eps=0.02, min_pts=5, backend="jit", shards=8
                    ).validate(sample=pts)
    model = DDC(cfg).fit(pts)            # batch fit, on the card
    model.partial_fit(shard=3, batch=new_pts)   # buffered (stream: ingested)
    model.labels_                        # global labels of fitted points
    model.query(probes)                  # point -> global cluster id
    model.comm_stats()                   # exact wire-byte accounting
    model.save("ckpt/"); DDC.load("ckpt/")   # bit-identical resume

The backend (``host`` | ``jit`` | ``stream`` | ``dist``) is a config
knob; all four produce the identical global clustering on the same
per-shard membership.  Configs
are validated at construction (``DDCConfig.validate``), so
schedule/backend mismatches and DESIGN.md §7 sizing violations fail
loudly before any work runs.  ``device`` is an argument, not a config
field; it defaults to ``"cuda"`` and never falls back to the CPU.
Snapshots carry the reference's format tag and layout, so either package
loads the other's.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile

import numpy as np
import torch

from repro_torch.core import ddc as core_ddc
from repro_torch.ddc import backends as backends_mod
from repro_torch.ddc.config import DDCConfig
from repro_torch.serve import faults as faults_mod

SNAPSHOT_FORMAT = "repro-ddc/v1"


class SnapshotError(RuntimeError):
    """A snapshot directory that cannot be loaded (truncated npz,
    corrupt or missing manifest, wrong format tag).  Raised by
    ``DDC.load`` *before* any model state is constructed, so a failed
    load never disturbs a live service."""


class DDC:
    """Estimator facade over a pluggable DDC execution backend."""

    def __init__(self, config: DDCConfig,
                 meter: core_ddc.CommMeter | None = None,
                 faults: "faults_mod.FaultPlan | None" = None, *,
                 device="cuda"):
        self.config = config.validate()
        cls = backends_mod.BACKENDS[config.backend]
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "DDC: device 'cuda' requested but CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        self._faults = faults
        self.backend = cls(self.config, meter=meter, faults=faults,
                           device=self.device)

    # -- write path --------------------------------------------------------

    def fit(self, points: np.ndarray, t: float | None = None) -> "DDC":
        """Cluster ``points`` (n, 2), block-partitioned over the
        configured shards.  Replaces any previously fitted state.

        ``t`` stamps the batch for TTL eviction (stream backend).  Pass
        it whenever later ``partial_fit``/``expire`` calls use wall-clock
        timestamps; the batch backends ignore it."""
        self.backend.fit(points, t=t)
        return self

    def partial_fit(self, shard: int, batch: np.ndarray,
                    t: float | None = None) -> "DDC":
        """Append ``batch`` to ``shard`` and fold it into the global
        clustering on the next read.  ``t`` stamps the batch for TTL
        eviction (stream backend; defaults to an ingest sequence
        number).  Batch backends re-run the full pipeline lazily on the
        next read."""
        self.backend.partial_fit(shard, batch, t=t)
        return self

    def expire(self, t: float) -> int:
        """Evict every point ingested with timestamp < ``t`` from all
        shards (stream/dist backends only).  Returns the eviction count."""
        return self.backend.expire(t)

    def tracks(self):
        """The cluster-tracking read view (DESIGN.md §14): the
        ``TrackSnapshot`` published alongside the query
        tier's versioned ``Snapshot`` — same version, so pairing
        ``labels_``/``query`` reads with ``tracks()`` observes one
        consistent generation.  Stream/dist backends with
        ``track=True`` only; folds pending writes first (like
        ``read_snapshot``), and returns None before anything is
        ingested."""
        return self.backend.tracks()

    # -- read path ---------------------------------------------------------

    @property
    def labels_(self) -> np.ndarray:
        """Global cluster ids of the fitted (live) points, in per-shard
        ingest order (== input order after a plain ``fit``)."""
        return self.backend.labels()

    @property
    def points_(self) -> np.ndarray:
        """The fitted (live) points, aligned with ``labels_``."""
        return self.backend.points()

    @property
    def n_clusters_(self) -> int:
        labels = self.labels_
        return len(set(labels[labels >= 0].tolist()))

    def query(self, points: np.ndarray, legacy: bool = False):
        """Global cluster id per query point: nearest clustered fitted
        point within ``eps`` (DBSCAN's border rule), else -1.

        Returns a ``QueryResult``: the labels plus the
        snapshot ``version`` that answered, the ``degraded`` flag, the
        routed ``scanned_shards``, and per-request latency.  The result
        duck-types as its labels ndarray (``np.asarray``, comparisons,
        indexing all work), so pre-redesign callers run unchanged;
        ``legacy=True`` returns the bare ndarray outright."""
        return self.backend.query(points, legacy=legacy)

    @property
    def query_tier(self):
        """The pipelined high-QPS read loop (DESIGN.md §12): bounded
        ``submit``/``drain`` queue, per-request deadlines, coalesced
        batched launches, snapshot-staleness policy from the config's
        ``max_staleness``."""
        return self.backend.query_tier

    def stats(self):
        """The typed ``ServiceStats`` contract: monotonic counters vs
        point-in-time gauges vs comm accounting, identical across the
        backends.  ``stats().as_dict()`` /
        ``stats().comm_dict()`` are the legacy dict views."""
        return self.backend.service_stats()

    def comm_stats(self) -> dict:
        """Exact trace-time wire accounting for the chosen backend
        (legacy flat dict view; see ``stats()`` for the typed form)."""
        return self.backend.comm_stats()

    # -- snapshot / restore ------------------------------------------------

    def save(self, path: str) -> str:
        """Serialise config + full backend state under directory ``path``.

        Both files are written to a sibling temp directory, fsynced, and
        published with ONE rename (the ``train/checkpoint.py`` idiom), so
        a reader can never observe a manifest from one save paired with
        arrays from another.  Overwrites swap via two renames: the
        previous snapshot is moved aside first and deleted last, so a
        crash mid-save leaves either the new snapshot at ``path`` or the
        old one recoverable under ``<path>.old-*`` — never a long
        no-checkpoint window.  A restored model resumes bit-identically —
        for the stream backend that includes the ring buffers, per-shard
        ClusterSets, and the cached pair-d2 matrix, so no re-cluster is
        needed on restart."""
        arrays, state_manifest = self.backend.state()
        manifest = {
            "format": SNAPSHOT_FORMAT,
            "config": self.config.to_manifest(),
            "state": state_manifest,
        }
        path = path.rstrip(os.sep)
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".tmp-",
                               dir=parent)
        np.savez(os.path.join(tmp, "state.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        for fn in os.listdir(tmp):
            fd = os.open(os.path.join(tmp, fn), os.O_RDONLY)
            os.fsync(fd)
            os.close(fd)
        old = None
        if os.path.exists(path):
            old = tempfile.mkdtemp(prefix=os.path.basename(path) + ".old-",
                                   dir=parent)
            os.rmdir(old)
            os.rename(path, old)
        os.rename(tmp, path)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        if self._faults is not None and self._faults.take_torn_snapshot():
            faults_mod.tear_snapshot(path)
        return path

    @classmethod
    def load(cls, path: str,
             meter: core_ddc.CommMeter | None = None,
             faults: "faults_mod.FaultPlan | None" = None, *,
             device="cuda") -> "DDC":
        """Rebuild a saved model; the stream backend resumes exactly
        where ``save`` left off (same labels, same cached matrices).
        ``meter`` becomes the restored backend's comm meter — it counts
        traffic from this process on; a snapshot does not replay the
        saved run's collectives.

        Every snapshot defect — missing or corrupt ``manifest.json``, a
        truncated/torn ``state.npz``, a format-tag mismatch, missing
        manifest keys — raises ``SnapshotError``, and it is raised
        *before* the model object is built: both files are parsed fully
        up front, so a failed load cannot leave a half-restored model or
        touch any live service the caller keeps running.  ``device`` is
        where the restored model runs."""
        # Parse-then-construct: read and validate EVERYTHING before
        # building the model, so failure here is side-effect free.
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            raise SnapshotError(f"{path}: unreadable manifest.json: {e}") \
                from e
        if not isinstance(manifest, dict) \
                or manifest.get("format") != SNAPSHOT_FORMAT:
            fmt = manifest.get("format") if isinstance(manifest, dict) \
                else type(manifest).__name__
            raise SnapshotError(
                f"{path}: unknown snapshot format {fmt!r} "
                f"(expected {SNAPSHOT_FORMAT!r})")
        try:
            config = DDCConfig.from_manifest(manifest["config"])
            state_manifest = manifest["state"]
        except (KeyError, TypeError, ValueError) as e:
            raise SnapshotError(f"{path}: malformed manifest.json: {e}") \
                from e
        try:
            with np.load(os.path.join(path, "state.npz")) as z:
                arrays = {k: z[k] for k in z.files}
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            raise SnapshotError(
                f"{path}: truncated or corrupt state.npz: {e}") from e
        model = cls(config, meter=meter, faults=faults, device=device)
        try:
            model.backend.load_state(arrays, state_manifest)
        except (KeyError, TypeError, ValueError) as e:
            raise SnapshotError(
                f"{path}: snapshot state does not restore: {e}") from e
        return model

    # -- stream-backend introspection --------------------------------------

    @property
    def service(self):
        """The underlying service engine (stream/dist backends only) for
        callers that need engine internals (benchmarks, tests)."""
        return self.backend.service
