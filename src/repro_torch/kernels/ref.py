"""Plain PyTorch versions of the kernels: DDC's phase-1 and phase-2
kernels, and the LM stack's attention, SSD scan and MoE dispatch gather.

DDC's functions define the semantics their CUDA kernels must reproduce
bit for bit on the card, and are what the ops run for CPU tensors.  Every
floating-point step is a separate elementwise op in a fixed order, never
a matrix product: a BLAS may contract or reorder the depth-2 dot product,
and the kernels promise the exact float32 expression written here.  Where
the jitted reference computes a fused multiply-add (XLA contracts the
depth-2 sums of the pairwise squared distance, and the contour
distance's dx·dx + dy·dy), the step is ``fma_f32``, rounded once, and
the kernels use the hardware FMA at the same place.  The row loops bound
peak memory to ``ROW_CHUNK`` rows of the (n, n) matrix, and the
block-sparse versions and the contour distance to ``PAIR_CHUNK`` pair
tests at a time; each entry is computed independently and folded with
an integer sum or a min, which no order changes, so chunking changes no
bit.

``dispatch_gather`` (the MoE expert buffer, and its int8 wire form) is
exact too: a copy, or one float32 division and rounding per element.

The LM functions (``flash_attention``, ``flash_attention_chunked``,
``ssd_scan``, ``ssd_scan_chunked``) mirror ``repro/kernels/ref.py``
function by function: float32 einsums (IEEE float32 on the card: the
callers keep TF32 off), the result in the input's dtype.  Their kernels
sum in another order, so they are held to these within a tolerance.
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


def cross_min_d2(ca: torch.Tensor, cnta: torch.Tensor, va: torch.Tensor,
                 cb: torch.Tensor, cntb: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """Rectangular min squared distance between two padded contour buffers:
    (A, v, 2) × (B, v, 2) → (A, B), BIG (1e30) where either slot has no
    valid vertex; cnt*: (·,) i32 valid vertices per slot, v*: (·,) bool
    slot validity.  A slot pair with a padding vertex on either side also
    sees BIG in its min, exactly as the reference's where(valid, d2, BIG)
    over every vertex pair; so only the valid vertices are tested.  The
    vertex pair's d2 is fma(dy, dy, dx·dx), rounded once, as XLA:CPU
    contracts the jitted reference's sum((p − q) ** 2, -1) in
    ``ddc.cross_min_d2`` and ``kernels/ref.py::contour_min_d2``;
    fl(a − b) = −fl(b − a), so the form is symmetric bit for bit.  Chunked
    to ``PAIR_CHUNK`` vertex pairs; a min is exact in any order, so
    chunking changes no bit.  Reads the valid vertex counts on the host."""
    a, v, _ = ca.shape
    b = cb.shape[0]
    dev = ca.device
    ar = torch.arange(v, device=dev)
    pa = (ar[None, :] < cnta[:, None]) & va[:, None]                    # (A, v)
    pb = (ar[None, :] < cntb[:, None]) & vb[:, None]                    # (B, v)
    padded = ~pa.all(dim=1)[:, None] | ~pb.all(dim=1)[None, :]
    out = torch.where(padded, BIG, torch.inf).to(torch.float32)
    ia = pa.reshape(-1).nonzero()[:, 0]
    ib = pb.reshape(-1).nonzero()[:, 0]
    pta = ca.reshape(a * v, 2)[ia].to(torch.float32)
    ptb = cb.reshape(b * v, 2)[ib].to(torch.float32)
    sa, sb = ia // v, ib // v
    rows = max(1, PAIR_CHUNK // max(ib.shape[0], 1))
    for r0 in range(0, ia.shape[0], rows):
        p = pta[r0:r0 + rows]
        dx = p[:, 0:1] - ptb[None, :, 0]
        dy = p[:, 1:2] - ptb[None, :, 1]
        d2 = fma_f32(dy, dy, dx * dx)                                   # (r, nb)
        per_b = torch.full((p.shape[0], b), torch.inf, dtype=torch.float32, device=dev)
        per_b.scatter_reduce_(1, sb[None, :].expand_as(d2), d2, "amin")
        out.scatter_reduce_(0, sa[r0:r0 + rows, None].expand_as(per_b), per_b, "amin")
    return out


def contour_min_d2(contours: torch.Tensor, counts: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Phase-2 merge matrix: (m, m) min squared distance between every
    pair of padded contour buffers, BIG (1e30) where either slot has no
    valid vertex.  contours: (m, v, 2) f32; counts: (m,) i32; valid: (m,)
    bool.  ``cross_min_d2`` of the buffers with themselves: the same
    fma(dy, dy, dx·dx) as the jitted reference, bit for bit."""
    return cross_min_d2(contours, counts, valid, contours, counts, valid)


# -- LM stack: attention and the Mamba-2 SSD scan ----------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    window: int | None = None) -> torch.Tensor:
    """Exact attention.  q: (b, h, sq, d), k/v: (b, hkv, skv, d); GQA with
    h a multiple of hkv (head i reads kv head i // rep).  Positions are
    right-aligned (query row r sits at skv − sq + r, so decode sees the
    whole cache); ``window``: attend to keys in (pos − window, pos].
    Masked logits are −inf, as in the reference, so a row with no visible
    key is NaN."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    rep = h // hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    skv = k.shape[2]
    dev = q.device
    qpos = torch.arange(sq, device=dev)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=dev)[None, :]
    if causal:
        logits = logits.masked_fill(~(kpos <= qpos), -torch.inf)
    if window is not None:
        logits = logits.masked_fill(~(kpos > qpos - window), -torch.inf)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def flash_attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True, scale: float | None = None,
                            window: int | None = None, bq: int = 512,
                            bk: int = 512) -> torch.Tensor:
    """Online-softmax attention over (bq, bk) blocks, as the reference's
    ``flash_attention_chunked``: the (sq, skv) logits never exist whole.
    Padding keys and masked logits get −1e30 (not −inf), every kv block
    is visited, and the sum is divided by max(l, 1e-30)."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    bq, bk = min(bq, sq), min(bk, skv)
    pq, pk = (-sq) % bq, (-skv) % bk
    qp = torch.nn.functional.pad(q, (0, 0, 0, pq)) if pq else q
    kp = torch.nn.functional.pad(k, (0, 0, 0, pk)) if pk else k
    vp = torch.nn.functional.pad(v, (0, 0, 0, pk)) if pk else v
    nq, nk = qp.shape[2] // bq, kp.shape[2] // bk
    qb = qp.reshape(b, hkv, rep, nq, bq, d).float() * scale
    kb = kp.reshape(b, hkv, nk, bk, d).float()
    vb = vp.reshape(b, hkv, nk, bk, d).float()
    q_off = skv - sq
    dev = q.device
    blocks = []
    for qi in range(nq):
        m_run = torch.full((b, hkv, rep, bq), -1e30, dtype=torch.float32, device=dev)
        l_run = torch.zeros((b, hkv, rep, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, rep, bq, d), dtype=torch.float32, device=dev)
        qpos = q_off + qi * bq + torch.arange(bq, device=dev)[:, None]
        for j in range(nk):
            s = torch.einsum("bgrqd,bgkd->bgrqk", qb[:, :, :, qi], kb[:, :, j])
            kpos = j * bk + torch.arange(bk, device=dev)[None, :]
            mask = kpos < skv
            if causal:
                mask = mask & (kpos <= qpos)
            if window is not None:
                mask = mask & (kpos > qpos - window)
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bgrqk,bgkd->bgrqd", p, vb[:, :, j])
            m_run = m_new
        blocks.append(acc / torch.clamp_min(l_run, 1e-30)[..., None])
    out = torch.stack(blocks, dim=3).reshape(b, h, nq * bq, d)[:, :, :sq]
    return out.to(q.dtype)


def ssd_scan_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     *, chunk: int = 128) -> torch.Tensor:
    """Chunked SSD, as the reference's ``ssd_scan_chunked``: per chunk the
    causal (C·Bᵀ ⊙ decay)·X product plus the carried state's
    contribution, then the state update.  Shapes as ``ssd_scan``.

    One deliberate difference: the decay above the diagonal is masked with
    ``where`` (as the reference's Pallas kernel masks it), not multiplied
    by 0.  There exp(cum_i − cum_j) grows, and once a chunk's decay sums to
    more than ~88 it overflows to inf, and the reference's inf·0 turns the
    whole output NaN (a Mamba-2 layer at init decays by ~0.7 a step, so a
    128-step chunk does).  The exponent is masked (to −inf) before the exp,
    so the gradient is finite too.  Wherever the reference is finite the
    two agree bit for bit."""
    bsz, l, h, dh = x.shape
    ds = b.shape[-1]
    ch = min(chunk, l)
    pad = (-l) % ch
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad))
    n = x.shape[1] // ch
    causal = torch.tril(torch.ones((ch, ch), dtype=torch.bool, device=x.device))
    state = torch.zeros((bsz, h, ds, dh), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(n):
        sl = slice(i * ch, (i + 1) * ch)
        xc, ac, bc, cc = (t[:, sl].float() for t in (x, a, b, c))
        cum = torch.cumsum(ac, dim=1)                                   # (bsz, ch, h)
        # Masked before the exp (exp(−inf) = 0), so that no masked entry
        # overflows: the same values as masking exp's output, and a
        # gradient without the 0 · inf = NaN an overflowed entry would give.
        decay = torch.exp(torch.where(causal[None, :, :, None],
                                      cum[:, :, None] - cum[:, None, :], -torch.inf))
        cb = torch.einsum("bihs,bjhs->bijh", cc, bc)
        y = torch.einsum("bijh,bjhd->bihd", cb * decay, xc)
        y = y + torch.exp(cum)[..., None] * torch.einsum("bihs,bhsd->bihd", cc, state)
        last = cum[:, -1]                                               # (bsz, h)
        w = torch.exp(last[:, None] - cum)                              # (bsz, ch, h)
        state = torch.exp(last)[..., None, None] * state + torch.einsum(
            "bihs,bihd,bih->bhsd", bc, xc, w)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :l].to(x.dtype)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """Mamba-2 SSD, the sequential recurrence.  x: (b, l, h, dh); a: (b, l,
    h) log-decay (≤ 0); b, c: (b, l, h, ds).  Returns y (b, l, h, dh) in
    x's dtype, with S_t = exp(a_t)·S_{t−1} + b_tᵀ x_t (ds, dh) and
    y_t = c_t · S_t, from S_0 = 0, all in float32."""
    bsz, l, h, dh = x.shape
    ds = b.shape[-1]
    state = torch.zeros((bsz, h, ds, dh), dtype=torch.float32, device=x.device)
    x32, a32, b32, c32 = x.float(), a.float(), b.float(), c.float()
    ys = []
    for t in range(l):
        state = state * torch.exp(a32[:, t])[..., None, None] \
            + b32[:, t][..., :, None] * x32[:, t][..., None, :]
        ys.append(torch.einsum("bhs,bhsd->bhd", c32[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype)


def dispatch_gather(x: torch.Tensor, idx: torch.Tensor, *, quant: bool):
    """MoE dispatch gather: ``buf[i] = x[idx[i]]`` for each of the S slots,
    zeros where ``idx[i] < 0`` (an empty slot).  x: (t, d); idx: (S,)
    integer.  Returns (buf (S, d), scales (S,) float32).

    Without ``quant``, buf has x's dtype and scales are 1.0 for a valid
    slot and 0.0 for an empty one.  With ``quant``, each row is computed
    in float32 as the reference's ``_gather_kernel`` writes it: scale =
    max(absmax / 127, 1e-12) (a true division), buf = clip(round(v /
    scale), −127, 127) as int8 (halves to even), and scale 0 for an
    empty slot.  An id >= t is an empty slot too, on every device, as
    the kernel treats it (the card checks nothing on the host)."""
    t, d = x.shape
    valid = (idx >= 0) & (idx < t)
    rows = x[idx.clamp(0, t - 1).long()]
    rows.masked_fill_(~valid[:, None], 0)   # in place: one (S, d) buffer at a time
    if not quant:
        return rows, valid.to(torch.float32)
    v = rows.to(torch.float32)
    absmax = v.abs().amax(dim=1)
    # A tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the true division the kernel does.
    scale = torch.clamp_min(absmax / torch.full_like(absmax, 127.0), 1e-12)
    q = torch.round(v / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, torch.where(valid, scale, 0.0)
