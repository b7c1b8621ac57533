"""Cluster tracking: stable identity, lifecycle events, and motion
analytics over the streaming serve stack (DESIGN.md §14).

Counterpart of the reference package's ``serve/tracking.py``.  The
match distance runs on the device the engine's tensors lie on (B5's
rectangular form, ``core.ddc.cross_min_d2``, then a min over member
slots); everything the track state is made of stays on the host in
NumPy float64, as in the reference, because its bits are what the
reference promises: ``np.mean``'s pairwise summation decides a
centroid, ``np.hypot`` / ``np.degrees`` / ``np.arctan2`` a heading.

Every refresh of a serve engine produces a fresh global ``ClusterSet``
with no memory of the last one.  ``ClusterTracker`` folds those
refresh-by-refresh generations into persistent *tracks*: each new
global cluster is matched against the previous generation by minimum
squared contour distance (the same ``cross_min_d2`` primitive the
aggregation tree uses, no new geometry), matched clusters keep their
track ID, and the unmatched remainder becomes lifecycle events —
birth, death, merge, split, continuation.  Per track, a bounded history
ring of (generation, centroid, size, spread) samples yields centroid
velocity, heading, spread/divergence rate, and a coarse
moving / stationary / dispersing classification.

Exactness.  The fold is a pure function of the per-generation inputs
``(batch contours, slot->global maps, global sizes)``.  Global cluster
*contours* are deliberately NOT used: the hierarchical aggregator's
root contours are re-extracted level by level and are not bit-identical
to the flat aggregator's, while the per-shard batch contours, the
canonical slot maps, and the global sizes ARE bit-identical across
flat vs tree aggregation.  Matching therefore runs on the *member-slot
view* — global cluster ``g`` is the set of shard contour slots mapping
to it — so the same ingest sequence yields bit-identical track
histories on every topology, and across snapshot save→load→resume
(tracker state rides in the mirror manifest+npz).

Aliasing: ``update`` reads the engine's aggregator mirror, which later
refreshes write in place, so the previous generation it keeps is a copy
(host arrays, and clones on the device).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import ddc as core_ddc
from repro_torch.core import geometry

EVENT_KINDS = ("birth", "death", "merge", "split", "continuation")
_KIND_CODE = {k: i for i, k in enumerate(EVENT_KINDS)}

# Motion classes (TrackView.motion).
MOTION_NEW = "new"                  # < 2 history samples, nothing to rate
MOTION_MOVING = "moving"
MOTION_STATIONARY = "stationary"
MOTION_DISPERSING = "dispersing"


@dataclasses.dataclass(frozen=True)
class TrackEvent:
    """One lifecycle transition at generation ``gen``.

    ``partner`` is the surviving track for a merge and the parent track
    for a split (else -1); ``slot`` is the global cluster slot the
    track occupies after the transition (-1 for a death).
    """

    kind: str
    gen: int
    track: int
    partner: int = -1
    slot: int = -1


@dataclasses.dataclass(frozen=True)
class TrackView:
    """Read-only per-track state + motion analytics at one generation."""

    track_id: int
    alive: bool
    slot: int                 # global cluster slot this generation, -1 if dead
    born_gen: int
    last_gen: int
    size: int                 # member points at last observation
    centroid: Tuple[float, float]
    velocity: Tuple[float, float]   # centroid delta per generation
    speed: float
    heading_deg: float        # atan2 degrees, 0 = +x, CCW positive
    spread: float             # RMS contour-vertex distance to centroid
    divergence: float         # spread delta per generation
    motion: str               # MOTION_* classification
    hits: int                 # history samples currently in the ring


@dataclasses.dataclass(frozen=True)
class TrackSnapshot:
    """The tracking read view published alongside the query tier's
    ``Snapshot`` — same ``version``, so a reader pairing ``labels()``
    with ``tracks()`` sees one consistent generation."""

    version: int
    epoch: int
    generation: int
    next_track_id: int
    births: int
    deaths: int
    merges: int
    splits: int
    continuations: int
    tracks: Tuple[TrackView, ...]       # all tracks ever, by ascending ID
    events: Tuple[TrackEvent, ...]      # bounded recent-event ring

    @property
    def alive(self) -> Tuple[TrackView, ...]:
        return tuple(t for t in self.tracks if t.alive)

    def track(self, track_id: int) -> Optional[TrackView]:
        for t in self.tracks:
            if t.track_id == track_id:
                return t
        return None


@dataclasses.dataclass
class _Track:
    tid: int
    slot: int
    born: int
    last: int
    alive: bool
    # History ring entries: (gen, cx, cy, size, spread), oldest first.
    hist: List[Tuple[float, float, float, float, float]]


class ClusterTracker:
    """Stable-identity fold over refresh generations (DESIGN.md §14).

    ``update`` is called by the serve engine once per *tracked* refresh
    with the post-merge batch contours, slot->global maps, and global
    ClusterSet (tensors on the engine's device); everything else is
    derived read-only state.
    """

    def __init__(self, cfg, history: int = 16, min_overlap: float = 0.0,
                 event_limit: int = 4096):
        if history < 2:
            raise ValueError(f"track history must be >= 2, got {history}")
        if not 0.0 <= min_overlap < 1.0:
            raise ValueError(
                f"match_min_overlap must be in [0, 1), got {min_overlap}")
        self.cfg = cfg
        self.history = int(history)
        self.min_overlap = float(min_overlap)
        self.event_limit = int(event_limit)
        # Motion thresholds scale with eps: a cluster moving less than a
        # quarter-eps per generation reads as stationary.
        self.speed_floor = 0.25 * float(cfg.eps)
        self.div_floor = 0.25 * float(cfg.eps)

        self.generation = 0
        self.next_track_id = 0        # monotone; IDs are never reused
        self.event_counts: Dict[str, int] = {k: 0 for k in EVENT_KINDS}
        self._tracks: Dict[int, _Track] = {}
        self._events: List[TrackEvent] = []
        self._prev: Optional[dict] = None   # last observed generation (host)
        # The same generation's contours, counts and maps on the device
        # (clones), or None after ``load_state`` until the next update.
        self._prev_dev: Optional[tuple] = None
        # Timing telemetry — excluded from serialized/compared state.
        self.last_update_ms = 0.0
        self.update_ms_total = 0.0

    # -- the fold ----------------------------------------------------------

    def update(self, batch, maps, global_cs) -> int:
        """Fold one merged generation; returns the new generation."""
        t0 = time.monotonic()
        c = int(self.cfg.max_clusters)
        v = int(self.cfg.max_verts)
        dev_contours = batch.contours.reshape(-1, v, 2)
        dev_counts = batch.counts.reshape(-1)
        dev_gmap = maps.reshape(-1)
        contours = core_ddc.host_copy(dev_contours)                  # float32
        counts = core_ddc.host_copy(dev_counts)                      # int32
        gmap = core_ddc.host_copy(dev_gmap).astype(np.int64)
        mvalid = gmap >= 0
        gsizes = core_ddc.host_copy(global_cs.sizes).astype(np.int64).reshape(-1)[:c]
        gvalid = core_ddc.host_copy(global_cs.valid).reshape(-1)[:c]

        self.generation += 1
        gen = self.generation
        cur_slots = [int(h) for h in np.nonzero(gvalid)[0]]
        feats = _slot_features(contours, counts, gmap, cur_slots)
        slot_track = np.full(c, -1, np.int64)
        prev = self._prev
        cur_dev = (dev_contours.clone(), dev_counts.clone(), dev_gmap.to(torch.int64))

        if prev is None or not prev["slots"]:
            for h in cur_slots:
                self._observe(self._new_track(gen, h), h, gen, gsizes, feats,
                              slot_track)
                self._emit("birth", gen, slot_track[h], slot=h)
        else:
            dg = self._global_d2(prev, cur_dev, gmap, cur_slots)
            r = float(self.cfg.merge_radius)
            thr = r * r * (1.0 - self.min_overlap)
            # Deterministic target per previous track: nearest current
            # slot within the gate, ties broken toward the lowest slot.
            target = {}
            for p in prev["slots"]:
                best = min(cur_slots, key=lambda h: (dg[p, h], h), default=None)
                target[p] = (best if best is not None and dg[p, best] <= thr else -1)
            for h in cur_slots:
                group = [p for p in prev["slots"] if target[p] == h]
                if group:
                    # Survivor: largest previous cluster, ties toward the
                    # older (lower) track ID; the rest merged into it.
                    surv = max(group, key=lambda p: (
                        prev["gsizes"][p], -prev["slot_track"][p]))
                    tid = int(prev["slot_track"][surv])
                    self._observe(tid, h, gen, gsizes, feats, slot_track)
                    self._emit("continuation", gen, tid, slot=h)
                    for p in group:
                        if p != surv:
                            dead = int(prev["slot_track"][p])
                            self._kill(dead)
                            self._emit("merge", gen, dead, partner=tid, slot=h)
                else:
                    near = [p for p in prev["slots"] if dg[p, h] <= thr]
                    tid = self._new_track(gen, h)
                    self._observe(tid, h, gen, gsizes, feats, slot_track)
                    if near:
                        # Split: fragment of the closest matched parent.
                        parent = min(near, key=lambda p: (
                            dg[p, h], prev["slot_track"][p]))
                        self._emit("split", gen, tid,
                                   partner=int(prev["slot_track"][parent]), slot=h)
                    else:
                        self._emit("birth", gen, tid, slot=h)
            for p in prev["slots"]:
                if target[p] == -1:
                    dead = int(prev["slot_track"][p])
                    self._kill(dead)
                    self._emit("death", gen, dead)

        self._prev = dict(contours=contours, counts=counts, mvalid=mvalid, gmap=gmap,
                          gsizes=gsizes, slot_track=slot_track,
                          slots=[h for h in cur_slots if slot_track[h] >= 0])
        self._prev_dev = cur_dev
        self.last_update_ms = (time.monotonic() - t0) * 1e3
        self.update_ms_total += self.last_update_ms
        return gen

    def _global_d2(self, prev, cur_dev, gmap, cur_slots) -> np.ndarray:
        """Member-slot distance: d2[g, h] = min over (previous members
        of g) x (current members of h) of ``cross_min_d2``, a (C, C)
        float64 array (``geometry.BIG`` where g or h has no member).
        Each side's validity is its member mask (map >= 0), not the
        batch's ``valid``, as in the reference."""
        c = int(self.cfg.max_clusters)
        cc, cn, cg = cur_dev
        dev = cc.device
        if self._prev_dev is None or self._prev_dev[0].device != dev:
            self._prev_dev = (torch.from_numpy(prev["contours"]).to(dev),
                              torch.from_numpy(prev["counts"]).to(dev),
                              torch.from_numpy(prev["gmap"]).to(dev))
        pc, pn, pg = self._prev_dev
        d2 = core_ddc.cross_min_d2(pc, pn, pg >= 0, cc, cn, cg >= 0)      # (A, B) f32
        # The min over member rows and columns, on the device: a min is
        # exact in any order, and float32 → float64 is exact and monotone,
        # so it equals the reference's float64 min.  Non-members go to an
        # extra group c.
        a = d2.shape[0]
        rows = torch.where(pg >= 0, pg, c)
        cols = torch.where(cg >= 0, cg, c)
        inf = torch.tensor(float("inf"), dtype=d2.dtype, device=dev)
        by_col = inf.expand(a, c + 1).clone().scatter_reduce_(
            1, cols[None, :].expand(a, -1), d2, "amin")                   # (A, C+1)
        by_both = inf.expand(c + 1, c + 1).clone().scatter_reduce_(
            0, rows[:, None].expand(-1, c + 1), by_col, "amin")           # (C+1, C+1)
        g = core_ddc.host_copy(by_both[:c, :c]).astype(np.float64)
        has_rows = np.zeros(c, bool)
        has_rows[prev["gmap"][prev["gmap"] >= 0]] = True
        has_cols = np.zeros(c, bool)
        has_cols[gmap[gmap >= 0]] = True
        dg = np.full((c, c), float(geometry.BIG), np.float64)
        for p in prev["slots"]:
            if not has_rows[p]:
                continue
            for h in cur_slots:
                if has_cols[h]:
                    dg[p, h] = g[p, h]
        return dg

    def _new_track(self, gen: int, slot: int) -> int:
        tid = self.next_track_id
        self.next_track_id += 1
        self._tracks[tid] = _Track(tid=tid, slot=slot, born=gen, last=gen,
                                   alive=True, hist=[])
        return tid

    def _observe(self, tid, slot, gen, gsizes, feats, slot_track) -> None:
        t = self._tracks[tid]
        cx, cy, spread = feats[slot]
        t.slot, t.last, t.alive = int(slot), gen, True
        t.hist.append((float(gen), cx, cy, float(gsizes[slot]), spread))
        if len(t.hist) > self.history:
            del t.hist[: len(t.hist) - self.history]
        slot_track[slot] = tid

    def _kill(self, tid: int) -> None:
        t = self._tracks[tid]
        t.alive, t.slot = False, -1

    def _emit(self, kind, gen, track, partner=-1, slot=-1) -> None:
        self._events.append(TrackEvent(kind, gen, int(track), int(partner), int(slot)))
        if len(self._events) > self.event_limit:
            del self._events[: len(self._events) - self.event_limit]
        self.event_counts[kind] += 1

    # -- read view ---------------------------------------------------------

    def snapshot(self, version: int = 0, epoch: int = 0) -> TrackSnapshot:
        ec = self.event_counts
        return TrackSnapshot(
            version=version, epoch=epoch, generation=self.generation,
            next_track_id=self.next_track_id, births=ec["birth"],
            deaths=ec["death"], merges=ec["merge"], splits=ec["split"],
            continuations=ec["continuation"],
            tracks=tuple(self._view(self._tracks[tid]) for tid in sorted(self._tracks)),
            events=tuple(self._events))

    def _view(self, t: _Track) -> TrackView:
        g1, cx, cy, size, spread = t.hist[-1]
        vx = vy = speed = heading = div = 0.0
        if len(t.hist) >= 2:
            g0, x0, y0, _, sp0 = t.hist[0]
            dt = g1 - g0
            vx, vy = (cx - x0) / dt, (cy - y0) / dt
            speed = float(np.hypot(vx, vy))
            heading = float(np.degrees(np.arctan2(vy, vx)))
            div = (spread - sp0) / dt
            if div > self.div_floor:
                motion = MOTION_DISPERSING
            elif speed > self.speed_floor:
                motion = MOTION_MOVING
            else:
                motion = MOTION_STATIONARY
        else:
            motion = MOTION_NEW
        return TrackView(
            track_id=t.tid, alive=t.alive, slot=t.slot, born_gen=t.born,
            last_gen=t.last, size=int(size), centroid=(cx, cy),
            velocity=(vx, vy), speed=speed, heading_deg=heading,
            spread=spread, divergence=div, motion=motion, hits=len(t.hist))

    # -- snapshot save/restore (manifest + npz, DESIGN.md §14) -------------

    def state_arrays(self) -> Dict[str, np.ndarray]:
        tids = sorted(self._tracks)
        nt, h = len(tids), self.history
        hist = np.zeros((nt, h, 5), np.float64)
        hlen = np.zeros(nt, np.int64)
        meta = np.zeros((nt, 5), np.int64)   # tid, slot, born, last, alive
        for i, tid in enumerate(tids):
            t = self._tracks[tid]
            meta[i] = (t.tid, t.slot, t.born, t.last, int(t.alive))
            hlen[i] = len(t.hist)
            if t.hist:
                hist[i, : len(t.hist)] = np.asarray(t.hist, np.float64)
        events = np.asarray(
            [[_KIND_CODE[e.kind], e.gen, e.track, e.partner, e.slot]
             for e in self._events], np.int64).reshape(-1, 5)
        out = {"trk_meta": meta, "trk_hist": hist, "trk_hlen": hlen,
               "trk_events": events}
        if self._prev is not None:
            p = self._prev
            out |= {"trk_prev_contours": p["contours"].copy(),
                    "trk_prev_counts": p["counts"].copy(),
                    "trk_prev_mvalid": p["mvalid"].copy(),
                    "trk_prev_gmap": p["gmap"].copy(),
                    "trk_prev_gsizes": p["gsizes"].copy(),
                    "trk_prev_slot_track": p["slot_track"].copy()}
        return out

    def state_manifest(self) -> dict:
        return {"generation": self.generation,
                "next_track_id": self.next_track_id,
                "history": self.history,
                "min_overlap": self.min_overlap,
                "event_limit": self.event_limit,
                "event_counts": dict(self.event_counts),
                "has_prev": self._prev is not None}

    def state_dict(self) -> Tuple[Dict[str, np.ndarray], dict]:
        return self.state_arrays(), self.state_manifest()

    def load_state(self, arrays, manifest: dict) -> None:
        self.generation = int(manifest["generation"])
        self.next_track_id = int(manifest["next_track_id"])
        self.history = int(manifest["history"])
        self.min_overlap = float(manifest["min_overlap"])
        self.event_limit = int(manifest["event_limit"])
        self.event_counts = {k: int(manifest["event_counts"].get(k, 0))
                             for k in EVENT_KINDS}
        meta = np.asarray(arrays["trk_meta"], np.int64).reshape(-1, 5)
        hist = np.asarray(arrays["trk_hist"], np.float64)
        hlen = np.asarray(arrays["trk_hlen"], np.int64)
        self._tracks = {}
        for i in range(len(meta)):
            tid, slot, born, last, alive = (int(x) for x in meta[i])
            self._tracks[tid] = _Track(
                tid=tid, slot=slot, born=born, last=last, alive=bool(alive),
                hist=[tuple(float(x) for x in row) for row in hist[i, : hlen[i]]])
        self._events = [
            TrackEvent(EVENT_KINDS[int(k)], int(g), int(t), int(p), int(s))
            for k, g, t, p, s in
            np.asarray(arrays["trk_events"], np.int64).reshape(-1, 5)]
        self._prev_dev = None
        if manifest.get("has_prev"):
            slot_track = np.array(arrays["trk_prev_slot_track"], np.int64)
            self._prev = dict(
                contours=np.array(arrays["trk_prev_contours"], np.float32),
                counts=np.array(arrays["trk_prev_counts"], np.int32),
                mvalid=np.array(arrays["trk_prev_mvalid"], bool),
                gmap=np.array(arrays["trk_prev_gmap"], np.int64),
                gsizes=np.array(arrays["trk_prev_gsizes"], np.int64),
                slot_track=slot_track,
                slots=[int(h) for h in np.nonzero(slot_track >= 0)[0]])
        else:
            self._prev = None


def _slot_features(contours, counts, gmap, cur_slots):
    """Pooled centroid + RMS spread per global slot, from the member
    shard contours' valid vertices in ascending flat-slot order (the
    one vertex set that is bit-identical on every topology), in float64
    NumPy on the host."""
    feats = {}
    for h in cur_slots:
        members = np.nonzero(gmap == h)[0]
        verts = [contours[a, : counts[a]].astype(np.float64)
                 for a in members if counts[a] > 0]
        if not verts:
            feats[h] = (0.0, 0.0, 0.0)
            continue
        allv = np.concatenate(verts)
        cx, cy = (float(x) for x in allv.mean(axis=0))
        spread = float(np.sqrt(((allv - (cx, cy)) ** 2).sum(axis=1).mean()))
        feats[h] = (cx, cy, spread)
    return feats


def play(model, frames, window: Optional[int] = None):
    """Drive a stream ``DDC`` model through a trajectory: one refresh per
    frame (so tracker generation == frame step), points block-partitioned
    over shards, ``t=step`` timestamps, and — when ``window`` is given —
    sliding-window eviction of frames older than ``window`` steps.
    Returns the final ``TrackSnapshot``."""
    k = model.config.shards
    for step, frame in enumerate(frames):
        for shard, part in enumerate(np.array_split(frame, k)):
            if len(part):
                model.partial_fit(shard, part, t=float(step) * np.ones(len(part)))
        if window is not None and step + 1 > window:
            model.expire(float(step - window + 1))
        model.service.refresh()
    return model.tracks()
