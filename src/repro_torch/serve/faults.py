"""Seeded, deterministic fault injection for the serve stack (a copy of
the reference package's ``serve/faults.py``).

The serve engines exchange one fixed-size ClusterSet per dirty
shard per refresh.  This module models everything that can go wrong on
that exchange — and at the snapshot boundary — as a reproducible
``FaultPlan``: a seeded schedule of :class:`FaultEvent` s keyed on each
shard's *delivery ordinal* (how many deltas that shard has attempted to
deliver so far), so a chaos run replays bit-for-bit regardless of how
refreshes are numbered or interleaved.

Injectable fault kinds (``FAULT_KINDS``):

* ``drop``    — the delta never arrives; ``attempts`` consecutive
  deliveries are lost, so ``attempts <= max_retries`` is healed by the
  per-refresh retry loop and anything more quarantines the shard.
* ``delay``   — a one-attempt transient drop (always healed by retry).
* ``dup``     — a late duplicate of an already-merged delta shows up;
  the epoch fence must discard it (exactly-once merge).
* ``corrupt`` — slot metadata mangled out of range (vertex counts /
  sizes); the validation gate must reject it before the pair-d2 cache
  is touched.
* ``poison``  — NaN/inf contour vertices; likewise gated.
* ``kill``    — the lane dies mid-refresh: its device buffers are lost
  and the shard must be quarantined until journal-replay recovery.

Plus ``torn_snapshot``: the next ``DDC.save`` is truncated mid-write
(the byte-torn file must fail ``DDC.load`` with ``SnapshotError``).

This module is host NumPy only: the fault seam and the validation gate
run on host-side payload copies in the control plane, never on the
device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

FAULT_KINDS = ("drop", "delay", "dup", "corrupt", "poison", "kill")


class FaultError(RuntimeError):
    """Base class for injected transport faults."""


class DeltaDropped(FaultError):
    """The shard's delta never reached the aggregator this attempt."""


class LaneKilled(FaultError):
    """The shard's device lane died mid-refresh; its buffers are lost."""


class DeltaValidationError(ValueError):
    """An incoming delta failed the aggregator's validation gate."""


class RecoveryError(RuntimeError):
    """Journal replay diverged from the authoritative host mirrors."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``delivery`` is the 0-based ordinal of the shard's delta deliveries
    at which the event fires; ``None`` means "the shard's next
    delivery, whenever that is" (handy for benches that arm a fault at
    steady state).  ``attempts`` only matters for ``drop``: how many
    consecutive delivery attempts of that delta are lost.
    """
    kind: str
    shard: int
    delivery: int | None = None
    attempts: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.attempts < 1:
            raise ValueError("attempts must be >= 1")


class FaultPlan:
    """A seeded, deterministic schedule of faults.

    The plan is consulted once per (shard, delivery attempt) by the
    control plane's delta-exchange seam; per-shard delivery counters
    live here so the same plan object must not be shared between
    services.  Corruption payloads are drawn from a private
    ``default_rng(seed)`` so two runs with equal plans mangle
    identically.
    """

    def __init__(self, events: tuple = (), torn_snapshot: bool = False,
                 seed: int = 0):
        self.events = tuple(events)
        for ev in self.events:
            if not isinstance(ev, FaultEvent):
                raise TypeError(f"expected FaultEvent, got {type(ev)}")
        self.torn_snapshot = bool(torn_snapshot)
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self._deliveries: dict = {}   # shard -> deliveries attempted
        self._consumed: set = set()   # event indices that can't refire
        self._torn_used = False

    @classmethod
    def random(cls, seed: int, shards: int, n_faults: int = 3,
               horizon: int = 2, kinds=FAULT_KINDS,
               max_drop_attempts: int = 4,
               torn_snapshot: bool = False) -> "FaultPlan":
        """Draw a reproducible plan: ``n_faults`` events on distinct
        (shard, delivery) cells within the first ``horizon`` deliveries
        of each shard."""
        rng = np.random.default_rng(seed)
        cells = [(s, d) for s in range(shards) for d in range(horizon)]
        picks = rng.choice(len(cells), size=min(n_faults, len(cells)),
                           replace=False)
        events = []
        for p in picks:
            shard, delivery = cells[int(p)]
            kind = str(rng.choice(list(kinds)))
            attempts = int(rng.integers(1, max_drop_attempts + 1)) \
                if kind == "drop" else 1
            events.append(FaultEvent(kind=kind, shard=shard,
                                     delivery=delivery, attempts=attempts))
        return cls(events=tuple(events), torn_snapshot=torn_snapshot,
                   seed=seed)

    def on_delta(self, shard: int, attempt: int) -> FaultEvent | None:
        """The delta-exchange seam: called once per delivery attempt of
        ``shard``'s current delta.  ``attempt`` 0 is the first send of a
        new delta (it advances the shard's delivery ordinal); higher
        attempts are the refresh loop's retries of the same delta."""
        if attempt == 0:
            self._deliveries[shard] = self._deliveries.get(shard, -1) + 1
        ordinal = self._deliveries.get(shard, 0)
        for i, ev in enumerate(self.events):
            if i in self._consumed or ev.shard != shard:
                continue
            if ev.delivery is not None and ev.delivery != ordinal:
                continue
            if ev.kind == "drop":
                if attempt < ev.attempts:
                    return ev
                self._consumed.add(i)   # delta finally got through
                continue
            if attempt > 0:
                # one-shot kinds fire on the first attempt only
                continue
            self._consumed.add(i)
            return ev
        return None

    def mangle(self, kind: str, payload: dict) -> dict:
        """Deterministically corrupt a host-side delta payload (dict of
        numpy arrays: contours/counts/sizes/valid/overflow)."""
        out = {k: np.array(v, copy=True) for k, v in payload.items()}
        if kind == "poison":
            flat = out["contours"].reshape(-1)
            i = int(self._rng.integers(0, flat.size))
            j = int(self._rng.integers(0, flat.size))
            flat[i] = np.nan
            flat[j] = np.inf
        elif kind == "corrupt":
            slot = int(self._rng.integers(0, out["counts"].size))
            out["counts"].reshape(-1)[slot] = -7 if self._rng.integers(2) \
                else 7 * (out["contours"].shape[-2] + 1)
            out["sizes"].reshape(-1)[slot] = -5
        else:
            raise ValueError(f"mangle does not apply to kind {kind!r}")
        return out

    def take_torn_snapshot(self) -> bool:
        """One-shot: should the next snapshot write be torn?"""
        if self.torn_snapshot and not self._torn_used:
            self._torn_used = True
            return True
        return False


def validate_delta(payload: dict, cfg) -> None:
    """The aggregator's validation gate: every incoming delta is checked
    BEFORE it can touch the mirror or the cached pair-d2 matrix.  Raises
    :class:`DeltaValidationError` on the first violation."""
    contours = np.asarray(payload["contours"])
    counts = np.asarray(payload["counts"])
    sizes = np.asarray(payload["sizes"])
    if not np.isfinite(contours).all():
        raise DeltaValidationError("non-finite contour vertices")
    if counts.size and (counts.min() < 0 or counts.max() > cfg.max_verts):
        raise DeltaValidationError(
            f"slot vertex counts outside [0, {cfg.max_verts}]")
    if sizes.size and sizes.min() < 0:
        raise DeltaValidationError("negative cluster sizes")


def tear_snapshot(path: str, keep_frac: float = 0.5) -> None:
    """Simulate a torn (partial) snapshot write by byte-truncating the
    state file in place, as a crashed writer would leave it."""
    import os
    target = os.path.join(path, "state.npz")
    size = os.path.getsize(target)
    with open(target, "r+b") as f:
        f.truncate(max(1, int(size * keep_frac)))
