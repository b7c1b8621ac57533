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

Training: the LM ops are differentiable.  On the CPU (or under ``FORCE``)
autograd differentiates the plain versions as they run.  A CUDA call that
needs a gradient (grad mode on and an input that requires one) goes
through a ``torch.autograd.Function``: its forward launches the same
kernel as a call without a gradient (counted alike), and its backward
runs the plain version of the same function again on the saved inputs,
under grad mode, and returns ``torch.autograd.grad`` of it against the
incoming cotangent.  The backward is the plain version's VJP because the
reference defines no other gradient: its Pallas kernels have no VJP rule
(``jax.grad`` through them stops in ``pallas_call``'s JVP rule), so the
only gradient the reference computes is autodiff of the plain jnp
functions its ``ops`` run off the TPU.  The recompute follows this
module's size rule (``CHUNKED_ATTENTION_MIN``, ``PLAIN_SSD_CHUNK``), so
its memory stays bounded at long sequences.  A call without a gradient
(serving, ``torch.no_grad``) takes the plain kernel path and launches
exactly what it did before.

The dry run (``launch/dryrun.py``) traces the LM on fake tensors: tensors
on torch's ``meta`` device, which carry shapes, dtypes and strides and no
data.  While its count (``launch/cost.py``, in ``COUNT``) takes the
card's routes (``card``), a meta tensor routes as a card tensor does
(``_on_card``).  No kernel can launch on it: where a kernel would
launch, a meta tensor gets an output of the kernel's shape and dtype, and
the count gets the plain route's FLOPs in closed form
(``attention_flops``, ``ssd_flops``; the gather has none) and the
kernel's bytes (each input read once, each output written once: what the
reference's cost count charges a Pallas kernel, whose intermediates stay
on chip).  The backward pass runs ``_plain_vjp`` as
it does on the card, so the count sees its recompute op by op
(``COUNT.vjp`` traces it once a shape).  Launch counts do not move.
"""
from __future__ import annotations

import math
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
# The dry run's active count (``launch.cost.Count``), while one runs.
COUNT = None


def _on_card(t: torch.Tensor) -> bool:
    """Does an LM op on ``t`` take the card's route: a card tensor, or a
    meta tensor under a count of the card's routes?"""
    kind = t.device.type
    return kind == "cuda" or (kind == "meta" and COUNT is not None and COUNT.card)


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
    if FORCE == "ref" or not _on_card(q):
        return _plain_attention(q, k, v, causal, scale, window)
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, scale, window)
    return _attention_kernel(q, k, v, causal, scale, window)


def _attention_kernel(q, k, v, causal, scale, window):
    """B7 on card tensors; on meta ones, its output's shape and cost."""
    if q.device.type == "meta":
        _charge("flash_attention", attention_flops(q.shape, k.shape, v.shape),
                sum(map(distinct_bytes, (q, k, v))), (q.shape[:3] + v.shape[3:], q.dtype))
        return q.new_empty(q.shape[:3] + v.shape[3:])
    return _fa.flash_attention(q, k, v, causal=causal, scale=scale, window=window)


def _plain_attention(q, k, v, causal, scale, window):
    """The plain route of ``flash_attention`` (the reference's off the TPU)."""
    if q.shape[2] * k.shape[2] > CHUNKED_ATTENTION_MIN and v.shape[-1] == q.shape[-1]:
        return ref.flash_attention_chunked(q, k, v, causal=causal, scale=scale, window=window)
    return ref.flash_attention(q, k, v, causal=causal, scale=scale, window=window)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Mamba-2 SSD scan; x: (b, l, h, dh), a: (b, l, h) f32, b/c: (b, l, h,
    ds) → (b, l, h, dh).  A CUDA tensor launches the kernel of its route
    (``ssd_scan.route``; each kernel has its own chunk, ``ssd_scan.CHUNK``:
    the result depends on the chunk only through rounding).  The plain route (CPU tensors, or ``FORCE == "ref"``) is the
    reference's off the TPU: chunked at ``PLAIN_SSD_CHUNK`` when l >=
    2·PLAIN_SSD_CHUNK, the sequential recurrence otherwise."""
    if FORCE == "ref" or not _on_card(x):
        return _plain_ssd(x, a, b, c)
    if _needs_grad(x, a, b, c):
        return _SSDScan.apply(x, a, b, c)
    return _ssd_kernel(x, a, b, c)


def _ssd_kernel(x, a, b, c):
    """B8 on card tensors; on meta ones, its output's shape and cost."""
    if x.device.type == "meta":
        _charge("ssd_scan", ssd_flops(x.shape, b.shape[-1]), sum(map(distinct_bytes, (x, a, b, c))),
                (x.shape, x.dtype))
        return x.new_empty(x.shape)
    return _ssd.ssd_scan(x, a, b, c)


def _plain_ssd(x, a, b, c):
    """The plain route of ``ssd_scan`` (the reference's off the TPU)."""
    if x.shape[1] >= 2 * PLAIN_SSD_CHUNK:
        return ref.ssd_scan_chunked(x, a, b, c, chunk=PLAIN_SSD_CHUNK)
    return ref.ssd_scan(x, a, b, c)


def dispatch_gather(x: torch.Tensor, idx: torch.Tensor, *, quant: bool):
    """MoE dispatch gather: (buf (S, d), scales (S,)) with buf[i] =
    x[idx[i]], zeros where idx[i] < 0; int8 per-row absmax with
    ``quant``.  See ``ref.dispatch_gather``.  Differentiable in x without
    ``quant`` (the int8 form is a wire format, with no gradient)."""
    if FORCE == "ref":
        return ref.dispatch_gather(x, idx, quant=quant)
    if not quant and _on_card(x) and _needs_grad(x):
        return _DispatchGather.apply(x, idx)
    return _gather_kernel(x, idx, quant)


def _gather_kernel(x, idx, quant):
    """B9 on card tensors; on meta ones, its outputs' shapes and cost (the
    plain version where the count takes the plain routes)."""
    if x.device.type == "meta" and not _on_card(x):
        return ref.dispatch_gather(x, idx, quant=quant)
    if x.device.type == "meta":
        s, d = idx.shape[0], x.shape[1]
        dtype = torch.int8 if quant else x.dtype
        _charge("dispatch_gather", 0, s * d * x.element_size() + distinct_bytes(idx),
                ((s, d), dtype), ((s,), torch.float32))
        return x.new_empty((s, d), dtype=dtype), x.new_empty((s,), dtype=torch.float32)
    return _mg.dispatch_gather(x, idx, quant=quant)


# -- the dry run: closed forms of the plain routes' FLOPs ------------------------


def attention_flops(q_shape, k_shape, v_shape) -> int:
    """The matmul FLOPs of ``_plain_attention`` on these shapes, as
    ``torch.utils.flop_counter`` counts them: q·kᵀ and p·v over every
    (query, key) pair (neither plain route skips a masked block; the
    chunked one runs over the sequences padded to its blocks)."""
    b, h, sq, d = q_shape
    skv, dv = k_shape[2], v_shape[3]
    if sq * skv > CHUNKED_ATTENTION_MIN and dv == d:
        bq, bk = min(512, sq), min(512, skv)
        sq, skv = math.ceil(sq / bq) * bq, math.ceil(skv / bk) * bk
    return 2 * b * h * sq * skv * (d + dv)


def ssd_flops(x_shape, ds: int) -> int:
    """The matmul FLOPs of ``_plain_ssd`` on x (bsz, l, h, dh) and b, c of
    state size ``ds``: the chunked route's c·bᵀ and its product with x
    within each chunk, and the state's read and update (``bihs,bhsd`` and
    ``bihs,bihd,bih``), over the sequence padded to the chunk; the
    sequential route's c·S a step."""
    bsz, l, h, dh = x_shape
    if l < 2 * PLAIN_SSD_CHUNK:
        return 2 * bsz * l * h * ds * dh
    ch = PLAIN_SSD_CHUNK
    n = math.ceil(l / ch)
    return n * (2 * bsz * h * ch * ch * (ds + dh) + 4 * bsz * h * ch * ds * dh)


def distinct_bytes(t: torch.Tensor) -> int:
    """The bytes of the distinct elements of ``t`` (a stride-0 axis, as the
    Mamba layer's broadcast c, is read once; the dry run's count reads
    every tensor so)."""
    return t.element_size() * math.prod(n for n, st in zip(t.shape, t.stride()) if st)


def _charge(name: str, flops: int, read: int, *outputs) -> None:
    """Add a kernel call on meta tensors to the active count: ``flops``,
    ``read`` bytes and the bytes of ``outputs`` ((shape, dtype) each)
    written."""
    if COUNT is not None:
        COUNT.kernel(name, flops, read + sum(math.prod(shape) * dtype.itemsize
                                             for shape, dtype in outputs))


# -- gradients: the kernel forward, the plain version's VJP backward ----------


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(getattr(t, "requires_grad", False)
                                           for t in tensors)


def _plain_vjp(name: str, plain, inputs, needs, cotangent, opts=()):
    """``torch.autograd.grad`` of ``plain`` (the op ``name``'s plain version)
    recomputed on detached ``inputs`` (the tensors a kernel read) against
    ``cotangent``, for the inputs whose ``needs`` flag is set (None for the
    others).  ``opts``: the options ``plain`` closes over (the dry run's
    count keys its trace of a meta call by them and the shapes)."""
    if COUNT is not None and cotangent.device.type == "meta":
        return COUNT.vjp((name, opts), inputs, needs, cotangent,
                         lambda: _vjp(plain, inputs, needs, cotangent))
    return _vjp(plain, inputs, needs, cotangent)


def _vjp(plain, inputs, needs, cotangent):
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(plain(*leaves), wanted, cotangent, allow_unused=True))
    return [next(grads) if t.requires_grad else None for t in leaves]


class _FlashAttention(torch.autograd.Function):
    """B7 forward (the route ``flash_attention.route`` picks), the plain
    attention's VJP backward.  Saves q, k, v as the kernel read them (MLA's
    padded v included: the pad's gradient is cut off by ``F.pad``'s own
    backward, outside this Function)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, scale, window)
        return _attention_kernel(q, k, v, causal, scale, window)

    @staticmethod
    def backward(ctx, g):
        causal, scale, window = ctx.opts
        dq, dk, dv = _plain_vjp(
            "flash_attention", lambda q, k, v: _plain_attention(q, k, v, causal, scale, window),
            ctx.saved_tensors, ctx.needs_input_grad[:3], g, ctx.opts)
        return dq, dk, dv, None, None, None


class _SSDScan(torch.autograd.Function):
    """B8 forward (the route ``ssd_scan.route`` picks), the plain SSD's VJP
    backward.  Saves x, a, b, c as the kernel read them (the Mamba layer's
    stride-0 c included; its gradient comes back dense and ``expand``'s
    backward sums it)."""

    @staticmethod
    def forward(ctx, x, a, b, c):
        ctx.save_for_backward(x, a, b, c)
        return _ssd_kernel(x, a, b, c)

    @staticmethod
    def backward(ctx, g):
        return tuple(_plain_vjp("ssd_scan", _plain_ssd, ctx.saved_tensors,
                                ctx.needs_input_grad, g))


class _DispatchGather(torch.autograd.Function):
    """B9 forward (without ``quant``), the plain gather's VJP backward:
    each kept slot's cotangent row added to its token's row."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(x, idx)
        buf, scales = _gather_kernel(x, idx, False)
        ctx.mark_non_differentiable(scales)
        return buf, scales

    @staticmethod
    def backward(ctx, g, _g_scales):
        x, idx = ctx.saved_tensors
        (dx,) = _plain_vjp("dispatch_gather",
                           lambda x_: ref.dispatch_gather(x_, idx, quant=False)[0], (x,),
                           (True,), g)
        return dx, None


def launch_counts() -> dict[str, int]:
    return {**_pd.launches, **_cd.launches, **_fa.launches, **_ssd.launches, **_mg.launches}


def reset_launch_counts() -> None:
    """Zero every kernel's launch count, flash_attention's and ssd_scan's
    per-route counts (``route_launches``), moe_gather's per-mode counts
    (``mode_launches``) and contour_dist's compaction launches
    (``compact_launches``)."""
    for d in (_pd.launches, _cd.launches, _cd.compact_launches, _fa.launches,
              _fa.route_launches, _ssd.launches, _ssd.route_launches, _mg.launches,
              _mg.mode_launches):
        for k in d:
            d[k] = 0
