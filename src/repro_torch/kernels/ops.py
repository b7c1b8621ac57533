"""Public kernel entry points, dispatched by the device of the tensors,
and the active tile-pair list of the block-sparse phase 1.

A CUDA tensor goes to the hand-written CUDA kernel, a CPU tensor to the
plain version in ``ref``.  Nothing probes for a GPU: where a tensor lies
decides.  The kernels mask the ragged edge themselves, so nothing is
padded here.

``FORCE = "ref"`` sends every op to the plain version whatever the
device (the tests and the comparison phase of ``chip_smoke.py`` use it
to run the same path without the kernels on the card).  The LM ops
(``flash_attention``, ``ssd_scan``) route their plain versions exactly
as the reference's ``kernels/ops.py`` routes off the TPU: the chunked
forms for long sequences, the exact ones otherwise.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import contour_dist as _cd
from . import flash_attention as _fa
from . import moe_gather as _mg
from . import pairwise_dist as _pd
from . import ref
from . import ssd_scan as _ssd
from .ref import PAIR_FIRST, PAIR_VALID

FORCE: str | None = None


def use_gpu_kernels(t: torch.Tensor) -> bool:
    """Would an op on ``t`` launch a CUDA kernel right now?"""
    return FORCE != "ref" and t.device.type == "cuda"


def pairwise_dist_sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(n, m) squared distances between 2-D points, clipped at 0 (K-Means'
    assignment step)."""
    if FORCE == "ref":
        return ref.pairwise_dist_sq(x, y)
    return _pd.pairwise_dist_sq(x, y)


def neighbor_count(x: torch.Tensor, mask: torch.Tensor, eps) -> torch.Tensor:
    if FORCE == "ref":
        return ref.neighbor_count(x, mask, eps)
    return _pd.neighbor_count(x, mask, eps)


def min_label_sweep(x, mask, labels, core, eps) -> torch.Tensor:
    if FORCE == "ref":
        return ref.min_label_sweep(x, mask, labels, core, eps)
    return _pd.min_label_sweep(x, mask, labels, core, eps)


def contour_min_d2(contours: torch.Tensor, counts: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """(m, m) min squared distance between padded contour buffers (1e30
    where either side is empty).  contours: (m, v, 2); counts: (m,);
    valid: (m,) bool.  The kernel uses the difference form directly, so
    unlike the TPU path nothing is centred."""
    if FORCE == "ref":
        return ref.contour_min_d2(contours, counts, valid)
    return _cd.contour_min_d2(contours, counts, valid)


def cross_min_d2(ca: torch.Tensor, cnta: torch.Tensor, va: torch.Tensor,
                 cb: torch.Tensor, cntb: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """(A, B) min squared distance between two padded contour buffers
    (A, v, 2) × (B, v, 2), 1e30 where either side is empty: the rectangular
    form of ``contour_min_d2`` (the delta merge's dirty rows), whose rows
    equal the square form's bit for bit."""
    if FORCE == "ref":
        return ref.cross_min_d2(ca, cnta, va, cb, cntb, vb)
    return _cd.cross_min_d2(ca, cnta, va, cb, cntb, vb)


# -- block-sparse spatial pruning (DDC phase 1) ------------------------------


class TilePairs(NamedTuple):
    """Active tile-pair list of spatially sorted points, in the reference's
    static layout.

    rows/cols/flags: (T²,) int32 — active pairs first, in row-major order,
    the tail repeating the last active pair with flags 0; flags bit0 =
    PAIR_VALID (a real pair), bit1 = PAIR_FIRST (first pair of its row
    tile).  row_ptr (T + 1,) int32: CSR offsets of each row tile's run in
    that list (no kernel reads it any more; the tests and
    ``tools/sweep_sym_ab.py``'s older kernels do).  n_active: () int32;
    frac: () f32, n_active / T².

    The upper list, which the kernels walk (they test each unordered pair
    once):
    up_rows/up_cols (T(T − 1)/2,) int32 — the active pairs (I, J) with
    I < J first, in row-major order, then the inactive ones (never read);
    n_up: () int32, their count.  The T diagonal pairs are always active
    and are not listed.  The active set is symmetric (the box gap is), so
    the upper list and the diagonal hold every active pair once."""

    rows: torch.Tensor
    cols: torch.Tensor
    flags: torch.Tensor
    n_active: torch.Tensor
    frac: torch.Tensor
    row_ptr: torch.Tensor
    up_rows: torch.Tensor
    up_cols: torch.Tensor
    n_up: torch.Tensor


def build_tile_pairs(x: torch.Tensor, mask: torch.Tensor, eps, *, bt: int = 512) -> TilePairs:
    """Bounding-box pruning over ``bt``-point tiles of spatially sorted x.

    A tile pair is *active* when the min distance between the two tiles'
    bounding boxes (masked points only) is <= eps — every within-eps
    point pair lies in an active pair, so skipping the others is exact.
    Diagonal pairs are always active, so every row tile has a run.  The
    box gap's squared length is float32 fma(g1, g1, g0·g0), the form the
    jitted reference computes (XLA contracts its gap·gap sum), and frac
    is its float32 n_active · (1 / T²).  Also builds the upper list (see
    ``TilePairs``).  Needs no host sync."""
    n = x.shape[0]
    if bt <= 0 or n % bt:
        raise ValueError(f"n = {n} is not a multiple of the tile size bt = {bt}")
    t = n // bt
    dev = x.device
    xb = x.to(torch.float32).reshape(t, bt, 2)
    mb = mask.reshape(t, bt, 1)
    lo = torch.where(mb, xb, 3.4e38).amin(dim=1)                 # (T, 2)
    hi = torch.where(mb, xb, -3.4e38).amax(dim=1)
    has_pts = mb.any(dim=1)[:, 0]
    gap = torch.maximum(lo[:, None, :] - hi[None, :, :],
                        lo[None, :, :] - hi[:, None, :]).clamp_min(0.0)
    gap_d2 = ref.fma_f32(gap[..., 1], gap[..., 1], gap[..., 0] * gap[..., 0])
    eps_sq = torch.tensor(ref.eps_sq_f32(eps), dtype=torch.float32, device=dev)
    active = (gap_d2 <= eps_sq) & has_pts[:, None] & has_pts[None, :]
    active |= torch.eye(t, dtype=torch.bool, device=dev)
    per_row = active.sum(dim=1, dtype=torch.int32)
    row_ptr = torch.cat([per_row.new_zeros(1), torch.cumsum(per_row, 0, dtype=torch.int32)])
    n_active = row_ptr[-1]
    # Active flat indices first, in row-major order (a stable sort keeps
    # it, and needs no host sync); the tail repeats the last active pair.
    p = t * t
    idx = torch.argsort((~active.reshape(p)).to(torch.uint8), stable=True).to(torch.int32)
    is_real = torch.arange(p, dtype=torch.int32, device=dev) < n_active
    last = idx[(n_active - 1).clamp_min(0).long()]
    idx = torch.where(is_real, idx, last)
    rows, cols = idx // t, idx % t
    first = is_real & torch.cat([is_real.new_ones(1), rows[1:] != rows[:-1]])
    flags = is_real.to(torch.int32) * PAIR_VALID | first.to(torch.int32) * PAIR_FIRST
    # n_active / T² as the jitted reference computes it: XLA folds the
    # division by a constant into a multiply by its float32 reciprocal.
    inv = torch.tensor(np.float32(1.0) / np.float32(p), dtype=torch.float32, device=dev)
    frac = n_active.to(torch.float32) * inv
    iu = torch.triu_indices(t, t, 1, device=dev)
    up = active[iu[0], iu[1]]
    order = torch.argsort((~up).to(torch.uint8), stable=True)
    up_rows, up_cols = iu[0][order].to(torch.int32), iu[1][order].to(torch.int32)
    return TilePairs(rows, cols, flags, n_active, frac, row_ptr, up_rows, up_cols,
                     up.sum(dtype=torch.int32))


def neighbor_count_sparse(x: torch.Tensor, mask: torch.Tensor, eps, pairs: TilePairs,
                          *, bt: int = 512) -> torch.Tensor:
    """Block-sparse ``neighbor_count`` over spatially sorted points; n must
    be a multiple of ``bt`` (the dbscan path sorts and pads)."""
    if FORCE == "ref":
        return ref.neighbor_count_sparse(x, mask, eps, pairs.rows, pairs.cols,
                                         pairs.flags, bt)
    return _pd.neighbor_count_sparse(x, mask, eps, pairs, bt=bt)


def min_label_sweep_sparse(x, mask, labels, core, eps, pairs: TilePairs, *,
                           bt: int = 512) -> torch.Tensor:
    """Block-sparse ``min_label_sweep`` over spatially sorted points."""
    if FORCE == "ref":
        return ref.min_label_sweep_sparse(x, mask, labels, core, eps, pairs.rows,
                                          pairs.cols, pairs.flags, bt)
    return _pd.min_label_sweep_sparse(x, mask, labels, core, eps, pairs, bt=bt)


# -- LM stack: attention, the Mamba-2 SSD scan, the MoE dispatch gather --------

CHUNKED_ATTENTION_MIN = 2**21  # sq·skv above which the plain route is chunked
PLAIN_SSD_CHUNK = 128          # the plain route's SSD chunk (the reference's default)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    window: int | None = None) -> torch.Tensor:
    """q: (b, h, sq, d); k, v: (b, hkv, skv, d) → (b, h, sq, d).

    A CUDA tensor launches the kernel at any length; unequal q/v head
    dims (MLA) raise ``ValueError`` there.  The plain route (CPU tensors,
    or ``FORCE == "ref"``) is the reference's off the TPU: the chunked
    online softmax when sq·skv > 2**21 and the dims are equal, the exact
    version otherwise."""
    if FORCE == "ref" or q.device.type == "cpu":
        if (q.shape[2] * k.shape[2] > CHUNKED_ATTENTION_MIN
                and v.shape[-1] == q.shape[-1]):
            return ref.flash_attention_chunked(q, k, v, causal=causal, scale=scale,
                                               window=window)
        return ref.flash_attention(q, k, v, causal=causal, scale=scale, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, scale=scale, window=window)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Mamba-2 SSD scan; x: (b, l, h, dh), a: (b, l, h) f32, b/c: (b, l, h,
    ds) → (b, l, h, dh).  A CUDA tensor launches the kernel of its route
    (``ssd_scan.route``; each kernel has its own chunk, ``ssd_scan.CHUNK``:
    the result depends on the chunk only through rounding).  The plain route (CPU tensors, or ``FORCE == "ref"``) is the
    reference's off the TPU: chunked at ``PLAIN_SSD_CHUNK`` when l >=
    2·PLAIN_SSD_CHUNK, the sequential recurrence otherwise."""
    if FORCE == "ref" or x.device.type == "cpu":
        if x.shape[1] >= 2 * PLAIN_SSD_CHUNK:
            return ref.ssd_scan_chunked(x, a, b, c, chunk=PLAIN_SSD_CHUNK)
        return ref.ssd_scan(x, a, b, c)
    return _ssd.ssd_scan(x, a, b, c)


def dispatch_gather(x: torch.Tensor, idx: torch.Tensor, *, quant: bool):
    """MoE dispatch gather: (buf (S, d), scales (S,)) with buf[i] =
    x[idx[i]], zeros where idx[i] < 0; int8 per-row absmax with
    ``quant``.  See ``ref.dispatch_gather``."""
    if FORCE == "ref":
        return ref.dispatch_gather(x, idx, quant=quant)
    return _mg.dispatch_gather(x, idx, quant=quant)


def launch_counts() -> dict[str, int]:
    return {**_pd.launches, **_cd.launches, **_fa.launches, **_ssd.launches, **_mg.launches}


def reset_launch_counts() -> None:
    """Zero every kernel's launch count, flash_attention's and ssd_scan's
    per-route counts (``route_launches``) and contour_dist's compaction
    launches (``compact_launches``)."""
    for d in (_pd.launches, _cd.launches, _cd.compact_launches, _fa.launches,
              _fa.route_launches, _ssd.launches, _ssd.route_launches, _mg.launches):
        for k in d:
            d[k] = 0
