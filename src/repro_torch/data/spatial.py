"""Synthetic spatial datasets (NumPy; float32 (n, 2) in [0, 1]^2).

A copy of the reference package's generators that the port's tests and
``chip_smoke.py`` use, including ``morton_code`` in NumPy: it decides
the point order of the Morton-sorted layouts, and so which points land
in which shard, and reproduces the reference's float32 arithmetic bit
for bit.  All generators are deterministic in ``seed``.

The paper's D1 (10 000 points, nested shapes) and D2 (30 000 points,
circles + linked ovals) Chameleon sets are synthesised with the same
described structure.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

MORTON_BITS = 10


def morton_code(points, bounds=None, bits: int = MORTON_BITS) -> np.ndarray:
    """Interleaved grid-bit (Z-order) code per point, int32.

    ``bounds`` = (x0, y0, x1, y1); when None the points' own bounding box
    is used.  Every step is float32, as in the reference.
    """
    pts = np.asarray(points, np.float32)
    if bounds is None:
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
    else:
        lo = np.asarray(bounds[:2], np.float32)
        hi = np.asarray(bounds[2:], np.float32)
    g = 1 << bits
    scale = np.where(hi > lo, hi - lo, np.float32(1.0)).astype(np.float32)
    cell = ((pts - lo) / scale * np.float32(g)).astype(np.int32)
    cell = np.clip(cell, 0, g - 1)
    ix, iy = cell[:, 0], cell[:, 1]
    code = np.zeros(pts.shape[0], np.int32)
    for b in range(bits):
        code = code | (((ix >> b) & 1) << (2 * b + 1))
        code = code | (((iy >> b) & 1) << (2 * b))
    return code


def _ring(rng, n, cx, cy, r, width):
    theta = rng.uniform(0, 2 * np.pi, n)
    rad = r + rng.normal(0, width, n)
    return np.stack([cx + rad * np.cos(theta), cy + rad * np.sin(theta)], -1)


def _blob(rng, n, cx, cy, sx, sy=None, rot=0.0):
    sy = sx if sy is None else sy
    pts = rng.normal(0, 1, (n, 2)) * [sx, sy]
    c, s = np.cos(rot), np.sin(rot)
    pts = pts @ np.array([[c, -s], [s, c]]).T
    return pts + [cx, cy]


def _moon(rng, n, cx, cy, r, width, start, end):
    theta = rng.uniform(start, end, n)
    rad = r + rng.normal(0, width, n)
    return np.stack([cx + rad * np.cos(theta), cy + rad * np.sin(theta)], -1)


def make_d1(n: int = 10_000, seed: int = 0, noise_frac: float = 0.04) -> np.ndarray:
    """D1 analogue: different shapes, some clusters surrounded by others."""
    rng = np.random.default_rng(seed)
    n_noise = int(n * noise_frac)
    n_sig = n - n_noise
    w = np.array([0.22, 0.10, 0.18, 0.14, 0.14, 0.12, 0.10])
    counts = np.maximum((w / w.sum() * n_sig).astype(int), 1)
    counts[0] += n_sig - counts.sum()
    parts = [
        _ring(rng, counts[0], 0.30, 0.65, 0.16, 0.012),       # ring ...
        _blob(rng, counts[1], 0.30, 0.65, 0.025),             # ... surrounding a blob
        _moon(rng, counts[2], 0.72, 0.72, 0.13, 0.012, 0.25, np.pi - 0.25),
        _moon(rng, counts[3], 0.78, 0.56, 0.13, 0.012, np.pi + 0.25, 2 * np.pi - 0.25),
        _blob(rng, counts[4], 0.22, 0.22, 0.07, 0.03, 0.6),   # tilted ellipse
        _blob(rng, counts[5], 0.62, 0.22, 0.03),
        _blob(rng, counts[6], 0.84, 0.30, 0.025),
    ]
    noise = rng.uniform(0, 1, (n_noise, 2))
    pts = np.concatenate(parts + [noise])
    return np.clip(pts, 0.0, 1.0).astype(np.float32)


def make_d2(n: int = 30_000, seed: int = 1, noise_frac: float = 0.04) -> np.ndarray:
    """D2 analogue: 2 small circles, 1 big circle, 2 linked ovals."""
    rng = np.random.default_rng(seed)
    n_noise = int(n * noise_frac)
    n_sig = n - n_noise
    w = np.array([0.30, 0.12, 0.12, 0.23, 0.23])
    counts = np.maximum((w / w.sum() * n_sig).astype(int), 1)
    counts[0] += n_sig - counts.sum()
    big = _ring(rng, counts[0], 0.32, 0.68, 0.20, 0.02)
    c1 = _ring(rng, counts[1], 0.75, 0.80, 0.07, 0.015)
    c2 = _ring(rng, counts[2], 0.85, 0.55, 0.07, 0.015)
    ov1 = _blob(rng, counts[3], 0.40, 0.25, 0.10, 0.035, 0.5)
    ov2 = _blob(rng, counts[4], 0.58, 0.20, 0.10, 0.035, -0.5)  # linked: overlaps ov1
    noise = rng.uniform(0, 1, (n_noise, 2))
    pts = np.concatenate([big, c1, c2, ov1, ov2, noise])
    return np.clip(pts, 0.0, 1.0).astype(np.float32)


def make_clustered(n: int, k: int = 8, seed: int = 0,
                   spread: float = 0.02) -> np.ndarray:
    """k Gaussian blobs at uniform-random centres — the benchmark layout
    where most tile pairs are prunable (block-sparse phase 1)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.1, 0.9, (k, 2))
    pts = centers[rng.integers(0, k, n)] + rng.normal(0, spread, (n, 2))
    return pts.astype(np.float32)


def make_worm(n: int, seed: int = 1, waves: int = 3, amp: float = 0.2,
              width: float = 0.004) -> np.ndarray:
    """Long thin noisy sine curve: core-graph diameter ~ curve length/ε —
    the worst case for plain label sweeping (pointer-doubling benchmark)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)
    pts = np.stack([t, 0.5 + amp * np.sin(2 * waves * np.pi * t)], -1)
    return (pts + rng.normal(0, width, (n, 2))).astype(np.float32)


def _disc(rng, n, cx, cy, a, b=None, rot=0.0):
    """Uniform-density filled ellipse — no Gaussian tails, so cluster
    extents are sharp and DBSCAN boundaries are seed-stable."""
    b = a if b is None else b
    t = rng.uniform(0, 2 * np.pi, n)
    r = np.sqrt(rng.uniform(0, 1, n))
    pts = np.stack([a * r * np.cos(t), b * r * np.sin(t)], -1)
    c, s = np.cos(rot), np.sin(rot)
    return pts @ np.array([[c, -s], [s, c]]).T + [cx, cy]


def morton_sorted(pts: np.ndarray) -> np.ndarray:
    """Reorder points by 2-D Morton (Z-order) code so contiguous index
    blocks are spatially compact — the order block-partitioned shards
    see from a spatial partitioner."""
    return pts[np.argsort(morton_code(pts), kind="stable")]


def make_rings(n: int = 2048, seed: int = 2) -> np.ndarray:
    """Rings scenario (phase-2 benchmark): a ring *surrounding* a disc —
    the non-convexity case where a convex-hull contour would wrongly
    merge the pair — plus two separate rings.  Morton-ordered."""
    rng = np.random.default_rng(seed)
    w = np.array([0.34, 0.12, 0.27, 0.27])
    c = (w / w.sum() * n).astype(int)
    c[0] += n - c.sum()
    parts = [
        _ring(rng, c[0], 0.30, 0.64, 0.095, 0.004),
        _disc(rng, c[1], 0.30, 0.64, 0.010),
        _ring(rng, c[2], 0.74, 0.78, 0.050, 0.004),
        _ring(rng, c[3], 0.72, 0.20, 0.050, 0.004),
    ]
    return morton_sorted(np.clip(np.concatenate(parts), 0, 1).astype(np.float32))


def make_linked_ovals(n: int = 2048, seed: int = 3) -> np.ndarray:
    """Linked-ovals scenario (phase-2 benchmark): two overlapping tilted
    ovals that must merge into one global cluster across any partition
    cut, plus a separate small oval.  Morton-ordered."""
    rng = np.random.default_rng(seed)
    w = np.array([0.4, 0.4, 0.2])
    c = (w / w.sum() * n).astype(int)
    c[0] += n - c.sum()
    parts = [
        _disc(rng, c[0], 0.38, 0.56, 0.14, 0.05, 0.5),
        _disc(rng, c[1], 0.56, 0.50, 0.14, 0.05, -0.5),   # linked: overlaps
        _disc(rng, c[2], 0.82, 0.16, 0.07, 0.03, 0.2),
    ]
    return morton_sorted(np.clip(np.concatenate(parts), 0, 1).astype(np.float32))


def make_noise_heavy(n: int = 2048, seed: int = 4,
                     noise_frac: float = 0.3) -> np.ndarray:
    """Noise-heavy scenario (phase-2 benchmark): five compact uniform
    discs under 30 % background noise — exercises noise rejection, empty
    merge slots, and (at high shard counts) fully-noise shards.
    Morton-ordered."""
    rng = np.random.default_rng(seed)
    n_noise = int(n * noise_frac)
    n_sig = n - n_noise
    centers = np.array([[0.2, 0.2], [0.2, 0.8], [0.8, 0.2], [0.8, 0.8], [0.5, 0.5]])
    per = n_sig // 5
    parts = [
        _disc(rng, per + (n_sig - 5 * per if i == 0 else 0), cx, cy, 0.055)
        for i, (cx, cy) in enumerate(centers)
    ]
    noise = rng.uniform(0, 1, (n_noise, 2))
    return morton_sorted(
        np.clip(np.concatenate(parts + [noise]), 0, 1).astype(np.float32))


# Phase-2 benchmark/test layout registry: generator + the DDC parameters
# (eps, min_pts, grid, max_verts, max_clusters) tuned so every local AND
# merged contour fits the vertex budget at 2–32 shards and inter-cluster
# gaps clear both merge predicates with margin (DESIGN.md §7 sizing
# rule).  The same table as the reference package's.
PHASE2_LAYOUTS = {
    "rings": dict(make=make_rings, eps=0.008, min_pts=5,
                  grid=64, max_verts=80, max_clusters=8),
    "linked_ovals": dict(make=make_linked_ovals, eps=0.012, min_pts=5,
                         grid=48, max_verts=88, max_clusters=8),
    # Worm: the *merged* contour must hold the whole curve's boundary
    # (the tree schedule resolves non-leader slots against it), so the
    # raster is coarse enough that the global outline fits max_verts.
    "worm": dict(make=lambda n, seed=1: morton_sorted(
                     make_worm(n, seed=seed, waves=1, amp=0.1)),
                 eps=0.012, min_pts=5, grid=32, max_verts=96,
                 max_clusters=8),
    "noise_heavy": dict(make=make_noise_heavy, eps=0.012, min_pts=8,
                        grid=48, max_verts=64, max_clusters=8),
}


def make_blobs(
    n: int, k: int, seed: int = 0, spread: float = 0.02, margin: float = 0.12
) -> tuple[np.ndarray, np.ndarray]:
    """Well-separated Gaussian blobs (used by property tests: DDC must
    agree with sequential DBSCAN here).  Returns (points, true_labels)."""
    rng = np.random.default_rng(seed)
    # Centres on a jittered grid so blobs stay >= margin apart.
    g = int(np.ceil(np.sqrt(k)))
    cells = [(i, j) for i in range(g) for j in range(g)][:k]
    centers = (np.array(cells) + 0.5) / g
    centers += rng.uniform(-0.25 / g + margin / 4, 0.25 / g - margin / 4, centers.shape)
    labels = rng.integers(0, k, n)
    pts = centers[labels] + rng.normal(0, spread, (n, 2))
    return np.clip(pts, 0, 1).astype(np.float32), labels.astype(np.int32)


# The schedule-equivalence layouts of the reference's phase-2 test script
# (``tests/_phase2_script.py::CASES``): generator + (eps, min_pts, grid,
# max_verts, max_clusters), tuned so no local or merged contour
# overflows its budget at 2–16 shards.
PARITY_CASES = {
    "blobs": (lambda: make_blobs(1024, 5, seed=0, spread=0.015)[0],
              0.05, 5, 96, 48, 12),
    "clustered": (lambda: make_clustered(1024, 8, seed=0),
                  0.02, 5, 96, 64, 12),
    "d1": (lambda: make_d1(2048, seed=0), 0.02, 4, 64, 144, 16),
    "d2": (lambda: make_d2(2048, seed=1), 0.03, 4, 36, 104, 12),
    "worm_default": (lambda: make_worm(1024), 0.015, 5, 16, 96, 12),
}
PARITY_CASES |= {
    name: (lambda spec=spec: spec["make"](2048), spec["eps"], spec["min_pts"],
           spec["grid"], spec["max_verts"], spec["max_clusters"])
    for name, spec in PHASE2_LAYOUTS.items()
}


def shard_capacity(n: int, shards: int) -> int:
    """Ring slots per shard so a block partition of ``n`` points fits
    exactly: the largest ``np.array_split`` part, i.e. ceil(n/shards).
    The one sizing rule shared by the stream backend and the equivalence
    tests."""
    return max(-(-n // shards), 1)


def stream_batches(pts: np.ndarray, shards: int, batch: int,
                   order: str = "round_robin", seed: int | None = None):
    """Deterministic ingest schedule for the streaming serve engine.

    Block-partitions ``pts`` into ``shards`` contiguous parts (the same
    ``np.array_split`` ``ddc_host`` uses, so streaming≡batch equivalence
    compares identical per-shard memberships), slices each part into
    ``batch``-point chunks, and returns a list of (shard, chunk) pairs:

    * ``round_robin`` — interleave shards chunk-by-chunk (steady traffic
      touching every shard in turn);
    * ``sequential`` — all of shard 0's chunks, then shard 1's, …;
    * ``shuffled`` — a ``seed``-deterministic permutation of the chunks.

    Any order yields the same final per-shard point sets.
    """
    parts = np.array_split(np.arange(len(pts)), shards)
    per_shard = [
        [(s, pts[idx[o:o + batch]]) for o in range(0, len(idx), batch)]
        for s, idx in enumerate(parts)
    ]
    if order == "sequential":
        return [c for chunks in per_shard for c in chunks]
    rounds = max((len(c) for c in per_shard), default=0)
    interleaved = [chunks[r] for r in range(rounds)
                   for chunks in per_shard if r < len(chunks)]
    if order == "round_robin":
        return interleaved
    if order == "shuffled":
        rng = np.random.default_rng(seed)
        return [interleaved[i] for i in rng.permutation(len(interleaved))]
    raise ValueError(order)


# --------------------------------------------------------------------------
# Trajectory stream generators (cluster tracking, serve/tracking.py).
#
# Each generator produces a deterministic sequence of per-step point
# frames plus the ground-truth per-step centre and velocity field of
# every moving group.  Frames are Morton-ordered so a block partition
# hands each shard a spatially compact subset (same reasoning as
# ``morton_sorted`` above), which keeps per-shard density above
# ``min_pts`` at 8 shards.  One frame == one refresh generation.
# --------------------------------------------------------------------------


class Trajectory(NamedTuple):
    """A seeded moving-cluster stream.

    ``frames[t]`` is the (n_t, 2) float32 point cloud ingested at step
    ``t``; ``centers[t, b]`` / ``velocities[t, b]`` are the true centre
    and per-step displacement of group ``b`` at that step (the velocity
    field the tracker's analytics are checked against).
    """

    frames: tuple
    centers: np.ndarray       # (steps, B, 2) float64
    velocities: np.ndarray    # (steps, B, 2) float64


def _frames_from_paths(rng, centers, radii, weights, n_per_step):
    """Render centre paths into per-step Morton-ordered point frames."""
    steps, nb = centers.shape[:2]
    w = np.asarray(weights, np.float64)
    counts = np.maximum((w / w.sum() * n_per_step).astype(int), 1)
    counts[0] += n_per_step - counts.sum()
    frames = []
    for t in range(steps):
        parts = [
            _disc(rng, counts[b], centers[t, b, 0], centers[t, b, 1], radii[b])
            for b in range(nb)
        ]
        frames.append(morton_sorted(
            np.clip(np.concatenate(parts), 0, 1).astype(np.float32)))
    return tuple(frames)


def make_drifting_blobs(steps: int = 24, n_per_step: int = 96,
                        n_blobs: int = 3, seed: int = 0,
                        speed: float = 0.015,
                        radius: float = 0.05) -> Trajectory:
    """``n_blobs`` uniform discs drifting horizontally in separate
    lanes, bouncing off the arena walls — lanes are far apart so the
    groups never interact and a perfect tracker reports only
    continuations after the first generation (the ID-stability
    layout)."""
    rng = np.random.default_rng(seed)
    ys = (np.linspace(0.2, 0.8, n_blobs) if n_blobs > 1
          else np.array([0.5]))
    xs = rng.uniform(0.25, 0.75, n_blobs)
    vx = speed * rng.uniform(0.75, 1.25, n_blobs)
    vx *= np.where(np.arange(n_blobs) % 2 == 0, 1.0, -1.0)
    lo, hi = 0.12, 0.88
    centers = np.zeros((steps, n_blobs, 2))
    velocities = np.zeros((steps, n_blobs, 2))
    for t in range(steps):
        for b in range(n_blobs):
            nxt = xs[b] + vx[b]
            if nxt < lo or nxt > hi:       # bounce off the wall
                vx[b] = -vx[b]
            xs[b] += vx[b]
            centers[t, b] = (xs[b], ys[b])
            velocities[t, b] = (vx[b], 0.0)
    frames = _frames_from_paths(
        rng, centers, [radius] * n_blobs, [1.0] * n_blobs, n_per_step)
    return Trajectory(frames, centers, velocities)


def make_merging_crowds(steps: int = 24, n_per_step: int = 96,
                        seed: int = 1, speed: float = 0.02,
                        radius: float = 0.055) -> Trajectory:
    """Two crowds walking toward each other along one lane: they fuse
    into a single global cluster mid-run (merge event) and separate
    again after crossing (split event).  A stationary bystander group
    checks that unrelated tracks keep their IDs throughout."""
    rng = np.random.default_rng(seed)
    centers = np.zeros((steps, 3, 2))
    velocities = np.zeros((steps, 3, 2))
    for t in range(steps):
        centers[t, 0] = (0.22 + speed * t, 0.5)
        centers[t, 1] = (0.78 - speed * t, 0.5)
        centers[t, 2] = (0.5, 0.88)
        velocities[t, 0] = (speed, 0.0)
        velocities[t, 1] = (-speed, 0.0)
    frames = _frames_from_paths(
        rng, centers, [radius, radius, 0.04], [0.4, 0.4, 0.2], n_per_step)
    return Trajectory(frames, centers, velocities)


def make_convoys(steps: int = 20, n_per_step: int = 96, seed: int = 2,
                 speed: float = 0.02, radius: float = 0.04) -> Trajectory:
    """Two convoys of two vehicles each, moving in opposite lanes with a
    shared per-convoy velocity; in-convoy spacing stays above the merge
    radius — including the trail of window-aged points each vehicle
    drags behind it — so each vehicle keeps its own track while the
    analytics see the convoy's common heading."""
    rng = np.random.default_rng(seed)
    centers = np.zeros((steps, 4, 2))
    velocities = np.zeros((steps, 4, 2))
    for t in range(steps):
        centers[t, 0] = (0.10 + speed * t, 0.30)   # convoy A, eastbound
        centers[t, 1] = (0.36 + speed * t, 0.30)
        centers[t, 2] = (0.90 - speed * t, 0.72)   # convoy B, westbound
        centers[t, 3] = (0.64 - speed * t, 0.72)
        velocities[t, 0] = velocities[t, 1] = (speed, 0.0)
        velocities[t, 2] = velocities[t, 3] = (-speed, 0.0)
    frames = _frames_from_paths(
        rng, centers, [radius] * 4, [1.0] * 4, n_per_step)
    return Trajectory(frames, centers, velocities)


# Trajectory layout registry: generator + DDC parameters + the stream
# shape (steps, points per step, sliding-window length in steps).  Tuned
# like PHASE2_LAYOUTS: contours fit the vertex budget at 2-8 shards,
# inter-group gaps clear the merge radius (eps + 1.5*cell ≈ 0.051), and
# the per-step displacement stays well inside the match gate so
# continuations are unambiguous.
TRAJECTORY_LAYOUTS = {
    "drifting_blobs": dict(make=make_drifting_blobs, eps=0.02, min_pts=3,
                           grid=48, max_verts=96, max_clusters=8,
                           steps=24, n_per_step=96, window=4),
    "merging_crowds": dict(make=make_merging_crowds, eps=0.02, min_pts=3,
                           grid=48, max_verts=96, max_clusters=8,
                           steps=24, n_per_step=96, window=4),
    "convoys": dict(make=make_convoys, eps=0.02, min_pts=3,
                    grid=48, max_verts=96, max_clusters=8,
                    steps=20, n_per_step=96, window=4),
}


def trajectory_capacity(n_per_step: int, window: int, shards: int) -> int:
    """Ring slots per shard for a windowed trajectory run: the largest
    per-frame block-partition part times the frames live at once (the
    window plus the frame ingested before that step's eviction)."""
    return shard_capacity(n_per_step, shards) * (window + 1)
