"""Layers of the LM stack's serving path: the port of
``repro/models/layers.py`` for dense GQA/MQA attention (qk-norm, rope,
windows), multi-head latent attention (MLA), cross-attention, the MLP,
the one-card MoE layer and the Mamba-2 (SSD) block.

Parameters live in ``nn.Module``s whose leaves keep the reference's names
(``wq``, ``k_norm``, ``w_in``, ``a_log``, ...); the math lives in plain
functions named as in the reference (``rmsnorm``, ``attn_apply``,
``mamba_decode``, ...), which take such a module where the reference takes
a parameter dict.  Matmuls run in the parameters' dtype; norms, softmax,
rope, decode attention and the SSM state in float32, as in the reference.
On the card, float32 matmuls must run in IEEE float32 (the callers keep
TF32 off).  Prefill reaches the CUDA kernels through
``kernels.ops.flash_attention`` and ``kernels.ops.ssd_scan``; the MoE
layer builds its expert buffer through ``kernels.ops.dispatch_gather``
in prefill and decode alike, and cross-attention reaches the flash
kernel in decode too (one query row against the encoder's keys).
Decode runs no other kernel (float32 einsums and an elementwise
recurrence, as in the reference; MLA's absorbed decode likewise).

Not here yet: the MoE layer's expert-parallel (``epsum``, ``a2a``) forms
across cards (ROADMAP A10 item 6).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops


def _init(gen: torch.Generator | None, shape, scale=None, *, device=None,
          dtype=torch.float32) -> nn.Parameter:
    """normal(shape) · scale (default 1/√shape[0]) drawn in float32 from
    ``gen`` on ``device``, then cast to ``dtype``, as the reference's
    ``_init``; uninitialised when ``gen`` is None (parameters that are
    loaded afterwards)."""
    if gen is None:
        t = torch.empty(shape, device=device, dtype=dtype)
    else:
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        # Scaled in place: one float32 draw at a time on the card (kimi-k2's
        # stacked experts are 22.5 GB in float32).
        t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        t = t.mul_(scale).to(dtype)
    return nn.Parameter(t, requires_grad=False)


def _const(shape, value: float, *, device=None, dtype=torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, device=device, dtype=dtype),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# Norms / positional
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    """{"w"} for rmsnorm, {"w", "b"} for layernorm."""

    def __init__(self, cfg, d: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.w = _const((d,), 1.0, device=device, dtype=dtype)
        if cfg.norm == "layernorm":
            self.b = _const((d,), 0.0, device=device, dtype=dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalised in float32, rounded to x's dtype, THEN scaled by w (the
    reference's order)."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def norm_apply(cfg, p: Norm, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p.w, p.b, cfg.norm_eps)
    return rmsnorm(x, p.w, cfg.norm_eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, H, S, D) with even D; positions: (S,) or (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    if positions.dim() == 1:
        ang = positions.float()[None, None, :, None] * freqs
    else:
        ang = positions.float()[:, None, :, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.to(x.dtype)


def sinusoid_pos(seq: int, d: int, offset: int = 0, *, device=None) -> torch.Tensor:
    pos = np.arange(offset, offset + seq)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * dim / d))
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(emb, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, cfg, d: int, ff: int, gen=None, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.w1 = _init(gen, (d, ff), **kw)
        self.w2 = _init(gen, (ff, d), **kw)
        if cfg.act == "silu":
            self.w3 = _init(gen, (d, ff), **kw)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(cfg, p: MLP, x: torch.Tensor) -> torch.Tensor:
    h = x @ p.w1
    if cfg.act == "silu":
        h = F.silu(h) * (x @ p.w3)
    else:
        h = gelu(h)
    return h @ p.w2


# ---------------------------------------------------------------------------
# Attention — GQA/MQA (+ qk-norm, windows)
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, cfg, gen=None, *, device=None, dtype=torch.float32):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.wq = _init(gen, (d, h * hd), **kw)
        self.wk = _init(gen, (d, kv * hd), **kw)
        self.wv = _init(gen, (d, kv * hd), **kw)
        self.wo = _init(gen, (h * hd, d), 1.0 / math.sqrt(h * hd), **kw)
        if cfg.qk_norm:
            self.q_norm = _const((hd,), 1.0, **kw)
            self.k_norm = _const((hd,), 1.0, **kw)


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:  # (B,S,n*hd) -> (B,n,S,hd)
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:  # (B,n,S,hd) -> (B,S,n*hd)
    b, n, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, n * hd)


def gqa_qkv(cfg, p: Attention, x: torch.Tensor, positions: torch.Tensor):
    q = _split_heads(x @ p.wq, cfg.n_heads)
    k = _split_heads(x @ p.wk, cfg.n_kv_heads)
    v = _split_heads(x @ p.wv, cfg.n_kv_heads)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    if cfg.pos_embed == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply(cfg, p: Attention, x: torch.Tensor, *, causal: bool = True, window=None,
               positions: torch.Tensor | None = None):
    """Full-sequence (prefill) attention through the flash kernel.  Returns
    (out, (k, v)) so prefill can seed the cache."""
    b, s, d = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = gqa_qkv(cfg, p, x, positions)
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    return _merge_heads(o) @ p.wo, (k, v)


def attn_decode(cfg, p: Attention, x: torch.Tensor, cache: dict, pos: int, window=None,
                ring: bool = False):
    """One-token decode against a (B, kv, S, hd) cache.  ``pos``: the
    absolute position written.

    The cache is updated IN PLACE (the reference returns a new one): the
    new k/v go to slot ``pos`` (``pos % S`` with ``ring``), the start
    clamped to [0, S − 1] as ``dynamic_update_slice_in_dim`` clamps it.
    ``ring``: the cache is a circular buffer of exactly ``window`` slots,
    and every slot's absolute position is recovered arithmetically for the
    mask.  Attention runs in float32 einsums, as in the reference."""
    k_cache, v_cache = cache["k"], cache["v"]
    b = x.shape[0]
    s_max = k_cache.shape[2]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = gqa_qkv(cfg, p, x, positions)
    slot = pos % s_max if ring else pos
    slot = min(max(slot, 0), s_max - 1)
    k_cache[:, :, slot] = k_new[:, :, 0]
    v_cache[:, :, slot] = v_new[:, :, 0]
    kv = k_cache.shape[1]
    rep = cfg.n_heads // kv
    qg = q.reshape(b, kv, rep, cfg.head_dim)  # (B,kv,rep,hd) from (B,H,1,hd)
    logits = torch.einsum("bkrd,bksd->bkrs", qg.float(), k_cache.float()) \
        / math.sqrt(cfg.head_dim)
    slots = torch.arange(s_max, device=x.device)
    if ring:
        # Absolute position stored in each slot: the largest value <= pos
        # congruent to the slot index (mod s_max); negative = never written.
        abs_pos = pos - torch.remainder(pos - slots, s_max)
        mask = abs_pos >= 0
    else:
        mask = slots <= pos
        if window is not None:
            mask = mask & (slots > pos - window)
    logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkrs,bksd->bkrd", w, v_cache.float())
    o = o.reshape(b, 1, cfg.n_heads * cfg.head_dim).to(x.dtype)
    return o @ p.wo, cache


def attn_init(cfg, gen=None, *, cross: bool = False, device=None, dtype=torch.float32):
    """The attention module of a layer, as the reference's ``attn_init``:
    ``MLA`` for an MLA configuration's self-attention, ``Attention``
    otherwise (cross-attention included)."""
    if cfg.attn_kind == "mla" and not cross:
        return MLA(cfg, gen, device=device, dtype=dtype)
    return Attention(cfg, gen, device=device, dtype=dtype)


# --- Cross-attention (enc-dec: whisper) -------------------------------------


def cross_kv(cfg, p: Attention, enc_out: torch.Tensor):
    """Cross-attention K/V of the encoder output (once per sequence; the
    cache keeps them for decode): (B, kv, Fs, hd) views of the products."""
    k = _split_heads(enc_out @ p.wk, cfg.n_kv_heads)
    v = _split_heads(enc_out @ p.wv, cfg.n_kv_heads)
    return k, v


def cross_apply(cfg, p: Attention, x: torch.Tensor, kv) -> torch.Tensor:
    """Decoder cross-attention through the flash kernel: no mask, no rope.
    In decode x holds one token, a query row against every encoder key."""
    k, v = kv
    q = _split_heads(x @ p.wq, cfg.n_heads)
    o = ops.flash_attention(q, k, v, causal=False)
    return _merge_heads(o) @ p.wo


# --- MLA (multi-head latent attention, DeepSeek / MiniCPM3 style) ------------


class MLA(nn.Module):
    """The reference's ``mla_init`` leaves: ``w_dq`` (d, q_lora) and
    ``q_norm`` when the query is low-rank, ``w_uq`` (q_lora or d, h·(nope +
    rope)), ``w_dkv`` (d, kv_lora + rope), ``kv_norm``, ``w_uk`` (kv_lora,
    h·nope), ``w_uv`` (kv_lora, h·v) and ``wo`` (h·v, d), scaled as
    ``Attention``'s."""

    def __init__(self, cfg, gen=None, *, device=None, dtype=torch.float32):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        nope, rope_d, vd, qr = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_dim_per_head,
                                cfg.q_lora_rank)
        kw = dict(device=device, dtype=dtype)
        if qr:
            self.w_dq = _init(gen, (d, qr), **kw)
            self.q_norm = _const((qr,), 1.0, **kw)
        self.w_uq = _init(gen, (qr or d, h * (nope + rope_d)), **kw)
        self.w_dkv = _init(gen, (d, cfg.kv_lora_rank + rope_d), **kw)
        self.kv_norm = _const((cfg.kv_lora_rank,), 1.0, **kw)
        self.w_uk = _init(gen, (cfg.kv_lora_rank, h * nope), **kw)
        self.w_uv = _init(gen, (cfg.kv_lora_rank, h * vd), **kw)
        self.wo = _init(gen, (h * vd, d), 1.0 / math.sqrt(h * vd), **kw)


def _mla_q(cfg, p: MLA, x: torch.Tensor, positions: torch.Tensor):
    nope = cfg.qk_nope_dim
    cq = x
    if cfg.q_lora_rank:
        cq = rmsnorm(x @ p.w_dq, p.q_norm, cfg.norm_eps)
    q = _split_heads(cq @ p.w_uq, cfg.n_heads)                   # (B,H,S,nope+rope)
    return q[..., :nope], rope(q[..., nope:], positions, cfg.rope_theta)


def _mla_ckv(cfg, p: MLA, x: torch.Tensor, positions: torch.Tensor):
    r = cfg.kv_lora_rank
    dkv = x @ p.w_dkv                                            # (B,S,kv_lora+rope)
    c_kv = rmsnorm(dkv[..., :r], p.kv_norm, cfg.norm_eps)
    k_rope = rope(dkv[..., r:][:, None], positions, cfg.rope_theta)  # (B,1,S,rope)
    return c_kv, k_rope


def mla_apply(cfg, p: MLA, x: torch.Tensor, *, causal: bool = True, window=None,
              positions: torch.Tensor | None = None, pad_v: bool = True):
    """Full-sequence MLA through the flash kernel at the qk head dim
    (nope + rope), scale 1/√(nope + rope).  With ``pad_v`` (the default,
    as the reference) v is padded with zeros to the qk dim and the output
    cut back to v's, so the kernel sees equal dims; without it the dims
    differ, which only the plain route takes.  Returns (out, (c_kv,
    k_rope)) so prefill can seed the latent cache."""
    b, s, _ = x.shape
    h, nope, rope_d, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_dim_per_head
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    c_kv, k_rope = _mla_ckv(cfg, p, x, positions)
    k_nope = _split_heads(c_kv @ p.w_uk, h)                      # (B,H,S,nope)
    v = _split_heads(c_kv @ p.w_uv, h)                           # (B,H,S,vd)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(b, h, s, rope_d)], -1)
    dq = nope + rope_d
    scale = 1.0 / math.sqrt(dq)
    if pad_v and vd < dq:
        v = F.pad(v, (0, dq - vd))
        o = ops.flash_attention(q, k, v, causal=causal, window=window, scale=scale)[..., :vd]
    else:
        o = ops.flash_attention(q, k, v, causal=causal, window=window, scale=scale)
    return _merge_heads(o) @ p.wo, (c_kv, k_rope)


def mla_decode(cfg, p: MLA, x: torch.Tensor, cache: dict, pos: int):
    """Absorbed MLA decode against the latent cache {"ckv": (B, S, kv_lora),
    "kr": (B, S, rope)}, updated IN PLACE at slot ``pos`` (clamped to [0,
    S − 1], as ``dynamic_update_slice_in_dim`` clamps it).  W_uk is
    absorbed into the query and W_uv applied after the weighted sum, all
    in float32 einsums, as the reference computes it."""
    b = x.shape[0]
    h, nope, rope_d, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_dim_per_head
    r = cfg.kv_lora_rank
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)                # (B,H,1,·)
    c_new, kr_new = _mla_ckv(cfg, p, x, positions)               # (B,1,r) / (B,1,1,rope)
    ckv, krope = cache["ckv"], cache["kr"]
    s_max = ckv.shape[1]
    slot = min(max(pos, 0), s_max - 1)
    ckv[:, slot] = c_new[:, 0]
    krope[:, slot] = kr_new[:, 0, 0]
    q_lat = torch.einsum("bhqn,rhn->bhqr", q_nope.float(),
                         p.w_uk.reshape(r, h, nope).float())     # (B,H,1,r)
    logits = (torch.einsum("bhqr,bsr->bhqs", q_lat, ckv.float())
              + torch.einsum("bhqd,bsd->bhqs", q_rope.float(), krope.float())) \
        / math.sqrt(nope + rope_d)
    mask = torch.arange(s_max, device=x.device) <= pos
    wts = torch.softmax(torch.where(mask, logits, -1e30), dim=-1)
    o_lat = torch.einsum("bhqs,bsr->bhqr", wts, ckv.float())    # (B,H,1,r)
    o = torch.einsum("bhqr,rhv->bhqv", o_lat, p.w_uv.reshape(r, h, vd).float())
    o = o.transpose(1, 2).reshape(b, 1, h * vd).to(x.dtype)
    return o @ p.wo, cache


# ---------------------------------------------------------------------------
# MoE — one card (the reference's ``c.mesh is None`` route)
# ---------------------------------------------------------------------------


class MoE(nn.Module):
    """router (d, E), w1/w3 (E, d, f), w2 (E, f, d), and ``shared`` (an MLP
    of n_shared_experts · shared_d_ff) when the config has shared experts.
    Scales as the reference's ``moe_init``: the router 0.02, w2 1/√f, and
    w1/w3 ``_init``'s default 1/√shape[0], which for (E, d, f) is 1/√E,
    not 1/√d (a property of the reference, kept as it is)."""

    def __init__(self, cfg, gen=None, *, device=None, dtype=torch.float32):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_ff
        kw = dict(device=device, dtype=dtype)
        self.router = _init(gen, (d, e), 0.02, **kw)
        self.w1 = _init(gen, (e, d, f), **kw)
        self.w3 = _init(gen, (e, d, f), **kw)
        self.w2 = _init(gen, (e, f, d), 1.0 / math.sqrt(f), **kw)
        if cfg.n_shared_experts:
            sf = (cfg.shared_d_ff or cfg.expert_ff) * cfg.n_shared_experts
            self.shared = MLP(cfg, d, sf, gen, **kw)


class Routing(NamedTuple):
    """Where each token goes: the routing half of the reference's
    ``_moe_local``.  Token-copies are the t·k (token, choice) pairs in
    row-major order; ``order`` sorts them by expert, stably."""

    topi: torch.Tensor   # (t, k) int64 experts, best first (the lower id first on a tie)
    gates: torch.Tensor  # (t, k) float32, topv / max(Σ topv, 1e-9)
    order: torch.Tensor  # (t·k,) int64 copy ids, sorted by expert
    keep: torch.Tensor   # (t·k,) bool, in sorted order: within the expert's capacity
    slot: torch.Tensor   # (t·k,) int64 expert slot e·cap + rank; E·cap when dropped
    idx: torch.Tensor    # (E·cap,) int32: the token in each expert slot, −1 if empty


def _route(probs: torch.Tensor, k: int, capacity: int) -> Routing:
    """Top-k routing with per-expert capacity, as the reference computes
    it from ``probs`` (t, E): top-k by a stable descending sort (so ties go
    to the lower expert id, as ``jax.lax.top_k``), then ``route_given``.
    Needs no host sync."""
    topi = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]
    return route_given(probs, topi, capacity)


def route_given(probs: torch.Tensor, topi: torch.Tensor, capacity: int) -> Routing:
    """The routing of the choice ``topi`` (t, k), best first: the gates
    are ``probs``' values there, their sum folded left to right; a stable
    argsort of the copies by expert, ``first`` by a left searchsorted, and
    each copy's rank within its expert; copies ranked at or past
    ``capacity`` are dropped.  ``idx`` inverts the slot map for
    ``dispatch_gather``.  (A caller may pass another run's ``topi`` to
    route by its decisions.)"""
    t, e = probs.shape
    k = topi.shape[1]
    dev = probs.device
    topv = probs.gather(1, topi)
    total = topv[:, 0]
    for i in range(1, k):
        total = total + topv[:, i]
    gates = topv / torch.clamp_min(total, 1e-9)[:, None]
    fe = topi.reshape(-1)
    order = torch.argsort(fe, stable=True)
    le_s = fe[order]
    first = torch.searchsorted(le_s, torch.arange(e + 1, device=dev))
    rank = torch.arange(t * k, device=dev) - first[le_s]
    keep = rank < capacity
    slot = torch.where(keep, le_s * capacity + rank, e * capacity)
    # A dropped copy writes −1 to the spare last slot, which is cut off.
    tok = torch.where(keep, order // k, -1).to(torch.int32)
    idx = torch.full((e * capacity + 1,), -1, dtype=torch.int32, device=dev)
    idx = idx.scatter_(0, slot, tok)[:-1]
    return Routing(topi, gates, order, keep, slot, idx)


def _moe_local(cfg, p: MoE, x_flat: torch.Tensor, capacity: int):
    """Route x_flat (t, d) to all E experts on this card.  Returns (y (t,
    d), aux parts (top-1 counts (E,), prob sums (E,), t)).

    The expert buffer xe (E, cap, d) is ``dispatch_gather``'s copy of each
    slot's token row (zeros where empty), the reference's gather → mask →
    scatter.  The combine sums each token's k contributions in the
    reference's order, ascending position in the expert-sorted list, each
    add rounded in x's dtype (no float atomics)."""
    t, d = x_flat.shape
    e, k = cfg.n_experts, cfg.topk
    logits = (x_flat @ p.router).float()
    ex = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = ex / ex.sum(dim=-1, keepdim=True)                   # jax.nn.softmax
    r = _route(probs, k, capacity)

    # The same products as silu(xe·w1) * (xe·w3), then ·w2, with fewer
    # buffers alive at once: the activation in place, xe released before
    # the down projection, and ye written beside its empty last row.
    xe = ops.dispatch_gather(x_flat, r.idx, quant=False)[0].reshape(e, capacity, d)
    h = F.silu(torch.bmm(xe, p.w1), inplace=True)
    h.mul_(torch.bmm(xe, p.w3))
    del xe
    ye = x_flat.new_empty((e * capacity + 1, d))
    torch.bmm(h, p.w2, out=ye[:-1].view(e, capacity, d))
    ye[-1] = 0
    del h

    gate_s = (r.gates.reshape(-1)[r.order] * r.keep).to(ye.dtype)
    # pos[j, i]: where token j's i-th contribution sits in the sorted list.
    inv = torch.empty_like(r.order).scatter_(
        0, r.order, torch.arange(t * k, device=x_flat.device))
    pos = inv.reshape(t, k).sort(dim=1).values
    y = torch.zeros((t, d), dtype=x_flat.dtype, device=x_flat.device)
    for i in range(k):
        c = pos[:, i]                   # one contribution a token at a time
        y = y + ye[r.slot[c]] * gate_s[c][:, None]

    counts = torch.bincount(r.topi[:, 0], minlength=e).to(torch.float32)
    aux_parts = (counts, probs.sum(dim=0),
                 torch.full((), float(t), dtype=torch.float32, device=x_flat.device))
    return y, aux_parts


def _aux_from_parts(e: int, parts) -> torch.Tensor:
    f_sum, p_sum, t = parts
    t = torch.clamp_min(t, 1.0)
    return e * torch.sum((f_sum / t) * (p_sum / t))


def moe_apply(cfg, p: MoE, x: torch.Tensor):
    """x: (B, S, d) -> (y, aux loss), the reference's one-device route:
    capacity ⌈t·k / E · capacity_factor⌉ over the t = B·S tokens, then
    the shared expert, if any, added to the routed output."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.topk
    t = b * s
    cap = int(math.ceil(t * k / e * cfg.capacity_factor))
    y, parts = _moe_local(cfg, p, x.reshape(t, d), cap)
    y = y.reshape(x.shape)
    aux = _aux_from_parts(e, parts)
    if cfg.n_shared_experts:
        y = y + mlp_apply(cfg, p.shared, x)
    return y, aux


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) block
# ---------------------------------------------------------------------------


class Mamba(nn.Module):
    def __init__(self, cfg, gen=None, *, device=None, dtype=torch.float32):
        super().__init__()
        d, di, st, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        kw = dict(device=device, dtype=dtype)
        conv_dim = di + 2 * st
        self.w_in = _init(gen, (d, 2 * di + 2 * st + h), **kw)
        self.conv = _init(gen, (cfg.conv_kernel, conv_dim), 0.2, **kw)
        self.a_log = _const((h,), 0.0, **kw)
        self.dt_bias = _const((h,), 0.0, **kw)
        self.d_skip = _const((h,), 1.0, **kw)
        self.out_norm = _const((di,), 1.0, **kw)
        self.w_out = _init(gen, (di, d), **kw)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = logaddexp(x, 0) = max(x, 0) + log1p(exp(−|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv.  x: (B, S, C); w: (K, C).  ``state``: (B, K-1, C)
    tail from the previous segment (decode).  Returns (y, new_state)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return F.silu(y), xp[:, -(k - 1):]


def _mamba_project(cfg, p: Mamba, x: torch.Tensor):
    di, st, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    zxbcdt = x @ p.w_in
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * st]
    dt = softplus(zxbcdt[..., -h:] + p.dt_bias)                 # (B,S,h)
    return z, xbc, dt


def _mamba_ssd_inputs(cfg, p: Mamba, xbc: torch.Tensor, dt: torch.Tensor):
    b_, s_ = xbc.shape[0], xbc.shape[1]
    di, st, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    xs = xbc[..., :di].reshape(b_, s_, h, hd)
    bmat = xbc[..., di:di + st][:, :, None, :]                  # (B,S,1,st)
    cmat = xbc[..., di + st:][:, :, None, :]
    a = -torch.exp(p.a_log.float())                             # (h,) < 0
    a_dt = a[None, None, :] * dt                                # (B,S,h) f32 log-decay
    b_eff = bmat.expand(b_, s_, h, st) * dt[..., None]
    c_eff = cmat.expand(b_, s_, h, st)                          # a view: no copy
    return xs, a_dt, b_eff, c_eff


def mamba_apply(cfg, p: Mamba, x: torch.Tensor, conv_state=None, return_state: bool = False):
    """Full-sequence Mamba-2 block through the SSD kernel.  Returns (out,
    cache|None); with ``return_state`` the cache {"conv", "ssm"} seeds
    decode."""
    z, xbc, dt = _mamba_project(cfg, p, x)
    xbc, conv_tail = _causal_conv(xbc, p.conv, conv_state)
    xs, a_dt, b_eff, c_eff = _mamba_ssd_inputs(cfg, p, xbc, dt)
    y = ops.ssd_scan(xs, a_dt, b_eff, c_eff)                    # (B,S,h,hd)
    y = y + xs * p.d_skip[None, None, :, None]
    y = y.reshape(x.shape[0], x.shape[1], cfg.d_inner)
    y = rmsnorm(y * F.silu(z), p.out_norm, cfg.norm_eps)
    out = y @ p.w_out
    cache = None
    if return_state:
        # Final SSM state: S = sum_j exp(cum_last - cum_j) b_j^T x_j
        # (decayed contributions of every step; old steps underflow to 0,
        # which is the mathematically correct limit).
        cum = torch.cumsum(a_dt.float(), dim=1)                 # (B,S,h)
        w = torch.exp(cum[:, -1:, :] - cum)                     # (B,S,h)
        s_fin = torch.einsum("bsht,bshd->bhtd", b_eff.float() * w[..., None], xs.float())
        cache = {"conv": conv_tail, "ssm": s_fin}
    return out, cache


def mamba_decode(cfg, p: Mamba, x: torch.Tensor, cache: dict, pos: int):
    """One-step Mamba-2 recurrence.  cache: {"conv": (B,K-1,C), "ssm":
    (B,h,st,hd) float32}, updated IN PLACE (the reference returns a new
    one)."""
    z, xbc, dt = _mamba_project(cfg, p, x)                      # S = 1
    xbc, conv_tail = _causal_conv(xbc, p.conv, cache["conv"])
    xs, a_dt, b_eff, c_eff = _mamba_ssd_inputs(cfg, p, xbc, dt)
    s_prev = cache["ssm"]                                       # (B,h,st,hd)
    decay = torch.exp(a_dt[:, 0])[..., None, None]              # (B,h,1,1)
    s_new = s_prev * decay + b_eff[:, 0][..., :, None] * xs[:, 0][..., None, :]
    y = torch.einsum("bhs,bhsd->bhd", c_eff[:, 0].float(), s_new)[:, None]  # (B,1,h,hd)
    y = y + xs * p.d_skip[None, None, :, None]
    y = y.reshape(x.shape[0], 1, cfg.d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p.out_norm, cfg.norm_eps)
    cache["conv"].copy_(conv_tail)
    cache["ssm"].copy_(s_new)
    return y @ p.w_out, cache
