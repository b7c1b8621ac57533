"""Plain PyTorch versions of the phase-1 and phase-2 kernels.

Each function defines the semantics its CUDA kernel must reproduce bit
for bit on the card, and is what the ops run for CPU tensors.  Every
floating-point step is a separate elementwise op in a fixed order, never
a matrix product: a BLAS may contract or reorder the depth-2 dot product,
and the kernels promise the exact float32 expression written here.  Where
the jitted reference computes a fused multiply-add (XLA contracts the
depth-2 sums of the pairwise squared distance), the step is ``fma_f32``,
rounded once, and the kernels use the hardware FMA at the same place.
The row loops bound peak memory to ``ROW_CHUNK`` rows of the (n, n)
matrix, and the block-sparse versions to ``PAIR_CHUNK`` pair tests at a
time; each entry is computed independently and folded with an integer
sum or min, which no order changes, so chunking changes no bit.
"""
from __future__ import annotations

import numpy as np
import torch

SENTINEL = 2**30
BIG = 1e30
ROW_CHUNK = 2048
PAIR_CHUNK = 1 << 22  # point-pair tests per chunk of active tile pairs

# Tile-pair flag bits (see ops.build_tile_pairs): bit0 = the pair is real
# (not tail padding), bit1 = first pair of its row tile.
PAIR_VALID = 1
PAIR_FIRST = 2


def eps_sq_f32(eps) -> float:
    """float32(eps)², squared in float32 — how the jitted reference
    squares a traced eps.  Returned as a Python float that holds the
    float32 value exactly."""
    e = np.float32(eps)
    return float(e * e)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fma(a, b, c) = a·b + c rounded once, on any device (inputs
    float32, broadcast).  a·b is exact in float64; the float64 sum is
    rounded to odd (its last bit set when it is inexact, from the TwoSum
    error), which makes the rounding to float32 that follows the one
    correct rounding of a·b + c."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _row_chunks(n: int):
    for r0 in range(0, n, ROW_CHUNK):
        yield r0, min(r0 + ROW_CHUNK, n)


def _sqnorm(x: torch.Tensor) -> torch.Tensor:
    """|x|² = fma(x1, x1, x0·x0), as the jitted reference's sum(x*x)."""
    return fma_f32(x[:, 1], x[:, 1], x[:, 0] * x[:, 0])


def _d2_rows(xr: torch.Tensor, xxr: torch.Tensor, y: torch.Tensor,
             yy: torch.Tensor) -> torch.Tensor:
    """(xx_i + yy_j) − 2·fma(x_i1, y_j1, x_i0·y_j0) for a block of rows
    (r, 2) × columns (m, 2) → (r, m), or batched over a leading axis:
    (p, r, 2) × (p, m, 2) → (p, r, m).  The jitted reference's x @ y.T at
    depth 2 is that fma."""
    dot = fma_f32(xr[..., 1:2], y[..., None, :, 1], xr[..., 0:1] * y[..., None, :, 0])
    return (xxr[..., None] + yy[..., None, :]) - 2.0 * dot


def pairwise_dist_sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances (n, 2) × (m, 2) → (n, m), clipped at 0, in the
    expansion form the phase-1 kernels use.  Only 2-D points: the order of
    a wider sum is not defined here, so any other width raises."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != 2 or y.shape[1] != 2:
        raise ValueError(f"points must be (n, 2) and (m, 2), got {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xx, yy = _sqnorm(x), _sqnorm(y)
    out = torch.empty((x.shape[0], y.shape[0]), dtype=torch.float32, device=x.device)
    for r0, r1 in _row_chunks(x.shape[0]):
        out[r0:r1] = _d2_rows(x[r0:r1], xx[r0:r1], y, yy).clamp_min(0.0)
    return out


def neighbor_count(x: torch.Tensor, mask: torch.Tensor, eps) -> torch.Tensor:
    """Per point, the count of masked points within eps (self included);
    0 for a masked-out point.  x: (n, 2) f32, mask: (n,) bool → (n,) i32."""
    x = x.to(torch.float32)
    n = x.shape[0]
    xx = _sqnorm(x)
    thr = torch.tensor(eps_sq_f32(eps), dtype=torch.float32, device=x.device)
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    for r0, r1 in _row_chunks(n):
        adj = (_d2_rows(x[r0:r1], xx[r0:r1], x, xx) <= thr) & mask[None, :]
        cnt = adj.sum(dim=1, dtype=torch.int32)
        out[r0:r1] = torch.where(mask[r0:r1], cnt, 0)
    return out


def min_label_sweep(x: torch.Tensor, mask: torch.Tensor, labels: torch.Tensor,
                    core: torch.Tensor, eps) -> torch.Tensor:
    """One DBSCAN min-label sweep: per point, the min label over masked
    core points within eps, SENTINEL (2**30) where there is none."""
    x = x.to(torch.float32)
    n = x.shape[0]
    xx = _sqnorm(x)
    thr = torch.tensor(eps_sq_f32(eps), dtype=torch.float32, device=x.device)
    labels = labels.to(torch.int32)
    col_ok = mask & core
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    for r0, r1 in _row_chunks(n):
        ok = ((_d2_rows(x[r0:r1], xx[r0:r1], x, xx) <= thr)
              & col_ok[None, :] & mask[r0:r1, None])
        labs = torch.where(ok, labels[None, :], SENTINEL)
        out[r0:r1] = labs.amin(dim=1)
    return out


def _tile_pair_fold(x: torch.Tensor, mask: torch.Tensor, eps, rows: torch.Tensor,
                    cols: torch.Tensor, flags: torch.Tensor, bt: int, init: int,
                    contrib, fold) -> torch.Tensor:
    """Shared skeleton of the block-sparse versions: every real (row tile,
    column tile) pair of the list is tested point by point with the dense
    versions' expression, a chunk of pairs at a time, and its per-row
    result folded into its row tile with an integer sum or min.

    ``contrib(ok, c)`` maps the (p, bt, bt) within-eps mask of a chunk
    (both sides masked) and its column tiles (p,) to per-row results
    (p, bt) i32; ``fold(acc, r, out)`` folds them into acc (t, bt) i32."""
    n = x.shape[0]
    if bt <= 0 or n % bt:
        raise ValueError(f"n = {n} is not a multiple of the tile size bt = {bt}")
    t = n // bt
    x = x.to(torch.float32)
    xb = x.reshape(t, bt, 2)
    xxb = _sqnorm(x).reshape(t, bt)
    mb = mask.reshape(t, bt)
    thr = torch.tensor(eps_sq_f32(eps), dtype=torch.float32, device=x.device)
    real = (flags & PAIR_VALID) != 0
    rows, cols = rows[real].long(), cols[real].long()
    acc = torch.full((t, bt), init, dtype=torch.int32, device=x.device)
    step = max(1, PAIR_CHUNK // (bt * bt))
    for p0 in range(0, rows.shape[0], step):
        r, c = rows[p0:p0 + step], cols[p0:p0 + step]
        ok = ((_d2_rows(xb[r], xxb[r], xb[c], xxb[c]) <= thr)
              & mb[r][:, :, None] & mb[c][:, None, :])
        fold(acc, r, contrib(ok, c))
    return acc.reshape(n)


def neighbor_count_sparse(x: torch.Tensor, mask: torch.Tensor, eps, rows: torch.Tensor,
                          cols: torch.Tensor, flags: torch.Tensor, bt: int) -> torch.Tensor:
    """``neighbor_count`` over the real pairs of a tile-pair list of
    spatially sorted points (n a multiple of ``bt``): equal to the dense
    count when the list holds every tile pair with a within-eps point
    pair."""
    return _tile_pair_fold(
        x, mask, eps, rows, cols, flags, bt, 0,
        lambda ok, c: ok.sum(dim=2, dtype=torch.int32),
        lambda acc, r, out: acc.index_add_(0, r, out))


def min_label_sweep_sparse(x: torch.Tensor, mask: torch.Tensor, labels: torch.Tensor,
                           core: torch.Tensor, eps, rows: torch.Tensor,
                           cols: torch.Tensor, flags: torch.Tensor, bt: int) -> torch.Tensor:
    """``min_label_sweep`` over the real pairs of a tile-pair list."""
    n = x.shape[0]
    if bt <= 0 or n % bt:
        raise ValueError(f"n = {n} is not a multiple of the tile size bt = {bt}")
    lb = labels.to(torch.int32).reshape(n // bt, bt)
    cb = core.reshape(n // bt, bt)

    def contrib(ok, c):
        labs = torch.where(ok & cb[c][:, None, :], lb[c][:, None, :], SENTINEL)
        return labs.amin(dim=2)

    def fold(acc, r, out):
        acc.scatter_reduce_(0, r[:, None].expand_as(out), out, "amin", include_self=True)

    return _tile_pair_fold(x, mask, eps, rows, cols, flags, bt, SENTINEL, contrib, fold)


def contour_min_d2(contours: torch.Tensor, counts: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Phase-2 merge matrix: (m, m) min squared distance between every
    pair of padded contour buffers, BIG (1e30) where either slot has no
    valid vertex.  contours: (m, v, 2) f32; counts: (m,) i32; valid: (m,)
    bool.  Difference form (dx·dx + dy·dy), the semantic reference."""
    m, v, _ = contours.shape
    dev = contours.device
    pts = contours.to(torch.float32)
    vv = ((torch.arange(v, device=dev)[None, :] < counts[:, None])
          & valid[:, None])
    flat = pts.reshape(m * v, 2)
    fv = vv.reshape(m * v)
    out = torch.empty((m, m), dtype=torch.float32, device=dev)
    rows = max(1, ROW_CHUNK // max(v, 1))
    for r0 in range(0, m, rows):
        r1 = min(r0 + rows, m)
        p = pts[r0:r1].reshape(-1, 2)
        dx = p[:, 0:1] - flat[None, :, 0]
        dy = p[:, 1:2] - flat[None, :, 1]
        d2 = dx * dx + dy * dy
        ok = vv[r0:r1].reshape(-1)[:, None] & fv[None, :]
        d2 = torch.where(ok, d2, BIG)
        out[r0:r1] = d2.reshape(r1 - r0, v, m, v).amin(dim=(1, 3))
    return out
