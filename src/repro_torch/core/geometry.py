"""Computational-geometry primitives for DDC.

Two families live here:

* ``*_np`` — host-side NumPy implementations (exact, dynamic shapes): the
  oracles of the tests and of the host (paper-faithful) DDC path.
* Tensor functions — static-shape, mask-aware grid contours on the
  device.  Contours are fixed-size padded buffers, so a shard's clusters
  fit one ``ClusterSet``.  They are batched: a mask with leading slot
  dimensions (S, n) yields S contours at once, in place of a ``vmap``.

The paper extracts non-convex cluster boundaries by triangulation; here,
as in the reference package, a cluster is rasterised onto a global
occupancy grid and its boundary cells (occupied cells with an empty
4-neighbour) are the contour.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import fma_f32

Bounds = Tuple[float, float, float, float]

# ---------------------------------------------------------------------------
# NumPy reference geometry (host path + oracles)
# ---------------------------------------------------------------------------


def convex_hull_np(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain.  Returns hull vertices in CCW order.

    ``points``: (n, 2).  Handles degenerate inputs (n <= 2, collinear).
    """
    pts = np.unique(np.asarray(points, dtype=np.float64), axis=0)
    n = len(pts)
    if n <= 2:
        return pts
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: list = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: list = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.array(lower[:-1] + upper[:-1])


def point_in_polygon_np(query: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Crossing-number point-in-polygon test.

    ``query``: (m, 2); ``poly``: (v, 2) ordered vertices.  Returns (m,) bool.
    """
    query = np.atleast_2d(query)
    x, y = query[:, 0], query[:, 1]
    v = len(poly)
    inside = np.zeros(len(query), dtype=bool)
    j = v - 1
    for i in range(v):
        xi, yi = poly[i]
        xj, yj = poly[j]
        crosses = ((yi > y) != (yj > y)) & (
            x < (xj - xi) * (y - yi) / (yj - yi + 1e-30) + xi
        )
        inside ^= crosses
        j = i
    return inside


def _segments_intersect_np(p1, p2, q1, q2) -> bool:
    def orient(a, b, c):
        val = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        return 0 if abs(val) < 1e-12 else (1 if val > 0 else -1)

    o1, o2 = orient(p1, p2, q1), orient(p1, p2, q2)
    o3, o4 = orient(q1, q2, p1), orient(q1, q2, p2)
    if o1 != o2 and o3 != o4:
        return True

    def on_seg(a, b, c):
        return (
            min(a[0], b[0]) - 1e-12 <= c[0] <= max(a[0], b[0]) + 1e-12
            and min(a[1], b[1]) - 1e-12 <= c[1] <= max(a[1], b[1]) + 1e-12
        )

    if o1 == 0 and on_seg(p1, p2, q1):
        return True
    if o2 == 0 and on_seg(p1, p2, q2):
        return True
    if o3 == 0 and on_seg(q1, q2, p1):
        return True
    if o4 == 0 and on_seg(q1, q2, p2):
        return True
    return False


def polygons_overlap_np(a: np.ndarray, b: np.ndarray) -> bool:
    """Exact polygon-overlap test: bbox prefilter, then containment /
    edge-intersection.  This is the paper's phase-2 merge predicate."""
    if len(a) == 0 or len(b) == 0:
        return False
    if len(a) < 3 or len(b) < 3:
        # Degenerate: fall back to proximity of point sets.
        d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
        return bool(d.min() < 1e-9)
    if (a[:, 0].max() < b[:, 0].min() or b[:, 0].max() < a[:, 0].min()
            or a[:, 1].max() < b[:, 1].min() or b[:, 1].max() < a[:, 1].min()):
        return False
    if point_in_polygon_np(a[:1], b)[0] or point_in_polygon_np(b[:1], a)[0]:
        return True
    na, nb = len(a), len(b)
    for i in range(na):
        p1, p2 = a[i], a[(i + 1) % na]
        for j in range(nb):
            q1, q2 = b[j], b[(j + 1) % nb]
            if _segments_intersect_np(p1, p2, q1, q2):
                return True
    return False


def grid_contour_np(
    points: np.ndarray, bounds: Tuple[float, float, float, float], grid: int
) -> np.ndarray:
    """Occupancy-grid boundary of a point set (NumPy oracle for the JAX
    version).  Returns boundary-cell centres, unordered."""
    x0, y0, x1, y1 = bounds
    sx = (grid - 1) / max(x1 - x0, 1e-12)
    sy = (grid - 1) / max(y1 - y0, 1e-12)
    ix = np.clip(((points[:, 0] - x0) * sx).astype(int), 0, grid - 1)
    iy = np.clip(((points[:, 1] - y0) * sy).astype(int), 0, grid - 1)
    occ = np.zeros((grid, grid), dtype=bool)
    occ[ix, iy] = True
    padded = np.pad(occ, 1)
    interior = np.ones_like(occ)
    for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        interior &= padded[1 + dx : 1 + dx + grid, 1 + dy : 1 + dy + grid]
    boundary = occ & ~interior
    bx, by = np.nonzero(boundary)
    cx = x0 + (bx + 0.5) / sx
    cy = y0 + (by + 0.5) / sy
    return np.stack([cx, cy], axis=-1)


# ---------------------------------------------------------------------------
# Tensor geometry — static shapes, mask-aware, batched over slots
# ---------------------------------------------------------------------------

BIG = 1e30


def _raster(bounds: Bounds, grid: int):
    """(x0, y0, sx, sy): origin and cells per data unit, as Python floats."""
    x0, y0, x1, y1 = bounds
    sx = (grid - 1) / max(x1 - x0, 1e-12)
    sy = (grid - 1) / max(y1 - y0, 1e-12)
    return x0, y0, sx, sy


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def grid_occupancy(points: torch.Tensor, mask: torch.Tensor, bounds: Bounds,
                   grid: int) -> torch.Tensor:
    """Rasterise masked points onto a (grid, grid) bool occupancy map.

    points: (n, 2) f32; mask: (..., n) bool → (..., grid, grid).  Bounds
    are global (config-static) so cells align across shards.  Python
    float bounds and scales round to float32 before use, as the
    reference's weakly typed constants do.
    """
    x0, y0, sx, sy = _raster(bounds, grid)
    dev = points.device
    ix = ((points[:, 0] - _f32(x0, dev)) * _f32(sx, dev)).clamp(0, grid - 1).to(torch.int32)
    iy = ((points[:, 1] - _f32(y0, dev)) * _f32(sy, dev)).clamp(0, grid - 1).to(torch.int32)
    flat = (ix * grid + iy).long()                              # (n,)
    lead = mask.shape[:-1]
    s = int(np.prod(lead)) if lead else 1
    cells = grid * grid
    idx = (torch.arange(s, device=dev)[:, None] * cells + flat[None, :]).reshape(-1)
    occ = torch.zeros((s * cells,), dtype=torch.int32, device=dev)
    occ.index_add_(0, idx, mask.reshape(-1).to(torch.int32))
    return (occ > 0).reshape(*lead, grid, grid)


def grid_boundary(occ: torch.Tensor) -> torch.Tensor:
    """Boundary cells of (..., g, g) occupancy maps: occupied with at least
    one unoccupied 4-neighbour (erosion by a plus-shaped element)."""
    p = torch.nn.functional.pad(occ.to(torch.int32), (1, 1, 1, 1))
    interior = (p[..., 2:, 1:-1] * p[..., :-2, 1:-1]
                * p[..., 1:-1, 2:] * p[..., 1:-1, :-2])
    return occ & (interior == 0)


def cells_to_points(cells: torch.Tensor, bounds: Bounds, max_verts: int):
    """Select up to ``max_verts`` active cells of (..., g, g) maps, in
    row-major order, and return their centres.

    Returns (points (..., max_verts, 2) f32, count (...,) i32).

    The cell centre reproduces the compiled reference bit for bit: inside
    ``jit`` its ``x0 + (b + 0.5) / sx`` becomes a multiplication by the
    float32 reciprocal of the constant scale, fused with the add into one
    FMA, i.e. fma(b + 0.5, float32(1 / float32(sx)), x0).  The FMA is
    evaluated in float64: the product of two float32 values is exact
    there, and at cell-grid magnitudes so is the sum, so the one rounding
    to float32 is the FMA's.
    """
    grid = cells.shape[-1]
    x0, y0, sx, sy = _raster(bounds, grid)
    dev = cells.device
    lead = cells.shape[:-2]
    flat = cells.reshape(*lead, grid * grid)
    n_active = flat.sum(dim=-1, dtype=torch.int32)
    ar = torch.arange(grid * grid, dtype=torch.int32, device=dev)
    keys = torch.where(flat, ar, grid * grid + ar)
    chosen = torch.topk(keys, max_verts, dim=-1, largest=False, sorted=True).values
    valid = chosen < grid * grid
    chosen = torch.where(valid, chosen, 0)
    bx = torch.div(chosen, grid, rounding_mode="floor")
    by = chosen - bx * grid
    def centre(b: torch.Tensor, origin: float, scale: float) -> torch.Tensor:
        inv = float(np.float32(1.0) / np.float32(scale))      # exact in float64
        t = (b.to(torch.float32) + 0.5).to(torch.float64)
        return (t * inv + float(np.float32(origin))).to(torch.float32)

    pts = torch.stack([centre(bx, x0, sx), centre(by, y0, sy)], dim=-1)
    pts = torch.where(valid[..., None], pts, 0.0)
    return pts, torch.clamp(n_active, max=max_verts)


def extract_contour(points: torch.Tensor, mask: torch.Tensor, bounds: Bounds,
                    grid: int, max_verts: int):
    """Grid contour of masked point sets: points (n, 2), mask (..., n) →
    (contours (..., max_verts, 2), n_verts (...,)).  DDC's data reduction:
    the contour is the cluster's network representation."""
    occ = grid_occupancy(points, mask, bounds, grid)
    return cells_to_points(grid_boundary(occ), bounds, max_verts)


def convex_hull_torch(points: torch.Tensor, mask: torch.Tensor,
                      max_verts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jarvis-march (gift wrapping) convex hull with static shapes, the
    counterpart of the reference's ``convex_hull_jax``, on the device the
    tensors lie on.

    Returns (hull (max_verts, 2) from the lowest point, count () i32);
    masked-out points are ignored, rows past ``count`` are 0.  Each step
    scans the candidates in index order: candidate i replaces the current
    one if it is more clockwise (cross < 0), or collinear (|cross| < 1e-12)
    and farther, or if the current one is masked out or the step's origin.
    That fold is sequential (the threshold makes the relation intransitive,
    so the winner depends on the order), so each step builds, for every
    candidate i, the map "current candidate → next" as an index vector,
    and composes the n maps pairwise in ceil(log2 n) gathers.  The cross
    product is fma(ax, by, −(ay·bx)), as the compiled reference computes
    ``ax·by − ay·bx``; the squared distance fma(dy, dy, dx·dx).  No value
    is read back to the host.
    """
    n = points.shape[0]
    dev = points.device
    pts = torch.where(mask[:, None], points.to(torch.float32), BIG)
    key = pts[:, 1] * (2 * BIG) + pts[:, 0]
    start = key.argmin()                      # the first index on ties
    idx = torch.arange(n, device=dev)
    cur = start
    done = torch.zeros((), dtype=torch.bool, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    hull = []
    for _ in range(max_verts):
        o = pts[cur]
        a = pts - o                                              # candidate − origin
        # cross[s, i] = a[s]_x · a[i]_y − a[s]_y · a[i]_x
        cross = fma_f32(a[:, None, 0], a[None, :, 1], -(a[:, None, 1] * a[None, :, 0]))
        dist = fma_f32(a[:, 1], a[:, 1], a[:, 0] * a[:, 0])
        valid = mask & (idx != cur)
        take = valid[None, :] & ((cross < 0) | ((cross.abs() < 1e-12)
                                                & (dist[None, :] > dist[:, None])))
        stale = ~mask | (idx == cur)
        beats = take | (stale[:, None] & valid[None, :])          # [current s, candidate i]
        maps = torch.where(beats.T, idx[:, None], idx[None, :])  # row i: s → next
        while maps.shape[0] > 1:
            if maps.shape[0] % 2:
                maps = torch.cat([maps, idx[None, :]])
            maps = torch.gather(maps[1::2], 1, maps[0::2])       # later ∘ earlier
        nxt = maps[0, cur]
        hull.append(torch.where(done, BIG, o))
        count = count + (~done).to(torch.int32)
        done = done | (nxt == start)
        cur = nxt
    hull = torch.stack(hull)
    return torch.where(hull >= BIG, 0.0, hull), count


def vert_validity(counts: torch.Tensor, valid: torch.Tensor, max_verts: int) -> torch.Tensor:
    """(m, max_verts) per-vertex validity of padded contour buffers: the
    first ``counts[i]`` vertices of each valid slot are real."""
    ar = torch.arange(max_verts, device=counts.device)
    return (ar[None, :] < counts[:, None]) & valid[:, None]


def min_cross_distance_sq(a: torch.Tensor, a_count: torch.Tensor, b: torch.Tensor,
                          b_count: torch.Tensor) -> torch.Tensor:
    """Minimum squared distance between the first ``a_count`` rows of a
    (m, 2) and the first ``b_count`` rows of b (k, 2), 1e30 when either is
    empty; fma(dy, dy, dx·dx), as the compiled reference computes
    ``sum((a − b) ** 2, -1)``."""
    va = torch.arange(a.shape[0], device=a.device) < a_count
    vb = torch.arange(b.shape[0], device=b.device) < b_count
    d = a[:, None, :] - b[None, :, :]
    d2 = fma_f32(d[..., 1], d[..., 1], d[..., 0] * d[..., 0])
    return torch.where(va[:, None] & vb[None, :], d2, BIG).amin()


def _d2_rows(pts: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Squared distance of every point of pts (..., n, 2) to p (..., 2), as
    the compiled reference computes ``sum((pts - p) ** 2, -1)``: its
    compiler contracts the depth-2 sum into fma(dy, dy, dx·dx)."""
    d = pts - p[..., None, :]
    return fma_f32(d[..., 1], d[..., 1], d[..., 0] * d[..., 0])


def farthest_point_subsample(points: torch.Tensor, mask: torch.Tensor, k: int):
    """Greedy k-centre subsampling of masked point sets, batched: points
    (n, 2), mask (..., n) → (subset (..., k, 2), count (...,) i32).

    Starts at the first masked point and takes, k − 1 times, the point
    farthest from those taken (the first on ties).  Masked-out points sit
    at (1e30, 1e30), whose squared distances overflow to inf before they
    are replaced by −1, as in the reference.  Rows past ``count`` are 0.
    """
    lead = mask.shape[:-1]
    pts = torch.where(mask[..., None], points.to(torch.float32), BIG)   # (..., n, 2)
    n_valid = mask.sum(dim=-1, dtype=torch.int32)

    def point(idx: torch.Tensor) -> torch.Tensor:
        return torch.gather(pts, -2, idx[..., None, None].expand(*lead, 1, 2))[..., 0, :]

    start = mask.to(torch.uint8).argmax(dim=-1)                          # first masked
    d2 = torch.where(mask, _d2_rows(pts, point(start)), -1.0)
    taken = [start]
    for _ in range(k - 1):
        nxt = d2.argmax(dim=-1)
        taken.append(nxt)
        d2 = torch.minimum(d2, torch.where(mask, _d2_rows(pts, point(nxt)), -1.0))
    idx = torch.stack(taken, dim=-1)                                     # (..., k)
    subset = torch.gather(pts, -2, idx[..., None].expand(*lead, k, 2))
    count = n_valid.clamp(max=k)
    keep = torch.arange(k, device=mask.device) < count[..., None]
    return torch.where(keep[..., None], subset, 0.0), count

