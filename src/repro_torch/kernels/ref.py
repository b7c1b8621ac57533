"""Plain PyTorch versions of the phase-1 and phase-2 kernels.

Each function defines the semantics its CUDA kernel must reproduce bit
for bit on the card, and is what the ops run for CPU tensors.  Every
floating-point step is a separate elementwise op in a fixed order, never
a matrix product: a BLAS may contract or reorder the depth-2 dot product,
and the kernels promise the exact IEEE float32 expression written here.
The row loops bound peak memory to ``ROW_CHUNK`` rows of the (n, n)
matrix; each entry is computed independently, so chunking changes no bit.
"""
from __future__ import annotations

import numpy as np
import torch

SENTINEL = 2**30
BIG = 1e30
ROW_CHUNK = 2048


def eps_sq_f32(eps) -> float:
    """float32(eps)², squared in float32 — how the jitted reference
    squares a traced eps.  Returned as a Python float that holds the
    float32 value exactly."""
    e = np.float32(eps)
    return float(e * e)


def _row_chunks(n: int):
    for r0 in range(0, n, ROW_CHUNK):
        yield r0, min(r0 + ROW_CHUNK, n)


def _sqnorm(x: torch.Tensor) -> torch.Tensor:
    return x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]


def _d2_rows(xr: torch.Tensor, xxr: torch.Tensor, y: torch.Tensor,
             yy: torch.Tensor) -> torch.Tensor:
    """(xx_i + yy_j) − 2·(x_i0·y_j0 + x_i1·y_j1) for a block of rows."""
    dot = xr[:, 0:1] * y[None, :, 0] + xr[:, 1:2] * y[None, :, 1]
    return (xxr[:, None] + yy[None, :]) - 2.0 * dot


def pairwise_dist_sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances (n, 2) × (m, 2) → (n, m), clipped at 0, in the
    expansion form the phase-1 kernels use."""
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
