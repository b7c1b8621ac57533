"""Layers of the LM stack: the port of
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

Every full-sequence layer is differentiable (training: ``transformer.
loss_fn``): the kernels' ops are ``torch.autograd.Function``s on the card
(``kernels/ops.py``).  The reference's ``_f32c`` (a float32 upcast whose
cotangent comes back in the input's dtype) needs no custom function here:
``x.float()``'s backward already returns the cotangent in x's dtype.
Parameters are built with ``requires_grad=False`` (serving);
``transformer.init_params(..., trainable=True)`` turns it on.

**Over a mesh** (``parallel.api.ctx().mesh``, explicit SPMD, one rank a
mesh position): each parameter holds this rank's shard and its ``spec``
(``parallel/sharding.py``; ``sharded_build`` makes them so).  Every layer
computes on the shards the reference's ``spec_for`` gives it, as XLA's
partitioner does, and all-gathers a leaf over its other sharded axes
(``data`` under FSDP) just before use:

* attention (GQA, the encoder's, cross-attention) and MLA run
  head-parallel (``head_plan``): the column-parallel projections (``wq``/
  ``wk``/``wv``; ``w_uq``/``w_uk``/``w_uv``) on the rank's shard, B7 on
  its heads, the row-parallel ``wo`` on its rows, then the sum over
  ``model``.  Where the query heads do not divide the m lanes they run in
  g = gcd(H, m) groups of H/g heads on m/g lanes each, the reference's
  split (6 heads over 4 lanes: 2 groups of 3): each rank computes its
  shard of the projection, the products are all-gathered over ``model``
  and the rank takes its group's heads (kv heads likewise where they do
  not divide); B7 runs on whole heads, where the reference splits a GQA
  group's P·V over the head dim (the dry run names the difference).  The
  caches hold the kv heads the rank reads; MLA keeps its latent cache
  whole, and its replicated down-projections ``w_dq``/``w_dkv`` run split
  over ``model`` in training and decode (each rank 1/m of the columns,
  all-gathered), whole in prefill, as the reference's partitioner runs
  them.
* Mamba-2 (``mamba_lanes``) runs on the rank's ssm_heads / m heads: its
  columns of ``w_in`` (z, x and dt of its heads, its 1/m of the B and C
  columns, which every head reads), the conv on those channels, B and C
  all-gathered over ``model``, B8, the skip, the gate and the final state
  on its heads, the norm's sum of squares summed over ``model``, the
  row-parallel ``w_out``, then the sum over ``model``; the cache holds its
  conv channels and SSM heads.  ``w_in`` is gathered over ``model`` and
  cut head-aligned at use (``_mamba_local``): its ``spec_for`` shard is a
  contiguous 1/m of z | x | B | C | dt, not the rank's heads, and keeping
  that layout leaves checkpoints, ``params_from_jax``, ``unshard`` and
  elastic restores as they are.
* the dense and shared MLPs column/row-parallel over ``ff``, and the MoE
  layer the reference's islands: ``epsum`` (each ``model`` lane routes to
  its experts; the sum over ``model``) and ``a2a`` (experts over
  ``data``, expert-FFN over ``model``; routed tokens cross between
  ``data`` lanes by all-to-all, through B9's int8 rows under
  ``a2a_int8``).

The collectives are exact transposes in the backward pass
(``parallel/collectives.py``).
"""
from __future__ import annotations

import contextlib
import math
import threading
import types
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.parallel import api as par
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as shard_rules

_BUILD = threading.local()


@contextlib.contextmanager
def sharded_build(specs, mesh):
    """Parameters made inside keep this rank's shard of their whole draw:
    the i-th parameter made takes ``specs[i]`` (its per-group spec) and
    carries it as ``.spec``.  Each leaf is drawn whole, cut, and freed
    before the next, so no rank holds a whole model."""
    _BUILD.plan = (iter(specs), mesh)
    try:
        yield
    finally:
        _BUILD.plan = None


@contextlib.contextmanager
def recording(made: list):
    """Parameters made inside are appended to ``made``, in the order they
    are made."""
    _BUILD.made = made
    try:
        yield
    finally:
        _BUILD.made = None


def _leaf(make, shape) -> nn.Parameter:
    plan = getattr(_BUILD, "plan", None)
    if plan is None:
        p = nn.Parameter(make(shape), requires_grad=False)
        if getattr(_BUILD, "made", None) is not None:
            _BUILD.made.append(p)
        return p
    specs, mesh = plan
    spec = next(specs)
    t = make(shape)
    if any(e is not None for e in spec):
        t = shard_rules.shard_leaf(t, spec, mesh)
    p = nn.Parameter(t, requires_grad=False)
    p.spec = tuple(spec)
    return p


def _init(gen: torch.Generator | None, shape, scale=None, *, device=None,
          dtype=torch.float32) -> nn.Parameter:
    """normal(shape) · scale (default 1/√shape[0]) drawn in float32 from
    ``gen`` on ``device``, then cast to ``dtype``, as the reference's
    ``_init``; uninitialised when ``gen`` is None (parameters that are
    loaded afterwards)."""
    def make(shape):
        if gen is None:
            return torch.empty(shape, device=device, dtype=dtype)
        sc = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        # Scaled in place: one float32 draw at a time on the card (kimi-k2's
        # stacked experts are 22.5 GB in float32).
        t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return t.mul_(sc).to(dtype)
    return _leaf(make, shape)


def _const(shape, value: float, *, device=None, dtype=torch.float32) -> nn.Parameter:
    return _leaf(lambda shape: torch.full(shape, value, device=device, dtype=dtype), shape)


# ---------------------------------------------------------------------------
# Parameters over a mesh
# ---------------------------------------------------------------------------


def _mesh():
    return par.ctx().mesh


def _spec(t) -> tuple:
    return getattr(t, "spec", None) or ()


def gather_param(t: torch.Tensor, keep=()) -> torch.Tensor:
    """``t`` whole over every mesh axis its spec shards it on but ``keep``
    (a differentiable all-gather a sharded dimension); ``t`` itself when
    nothing is to gather."""
    mesh = _mesh()
    if mesh is None:
        return t
    spec = list(_spec(t))
    out = t
    for dim, entry in enumerate(spec):
        axes = shard_rules.spec_axes((entry,))
        if not axes or all(a in keep for a in axes):
            continue
        if any(a in keep for a in axes):
            raise ValueError(f"spec entry {entry} is kept only in part: {keep}")
        out = coll.all_gather(out, mesh, axes, dim)
        spec[dim] = None
    if out is not t:
        out.spec = tuple(spec)    # what stays sharded (``keep``)
    return out


def _whole(p, keep=()):
    """``p`` (a module of parameters) with each of its own parameters
    gathered as ``gather_param`` does, as a namespace with the same names
    (submodules as they are); ``p`` itself when none is sharded."""
    if _mesh() is None or not any(_spec(t) for t in p.parameters(recurse=False)):
        return p
    ns = types.SimpleNamespace(**dict(p.named_children()))
    for name, t in p.named_parameters(recurse=False):
        setattr(ns, name, gather_param(t, keep))
    return ns


def _model_lanes() -> tuple[int, int]:
    """(size of the ``model`` axis, this rank's lane on it); (1, 0)
    without one."""
    mesh = _mesh()
    if mesh is None or mesh.shape.get("model", 1) <= 1:
        return 1, 0
    return mesh.shape["model"], mesh.coords["model"]


def _sharded_on(t, dim: int, axis: str) -> bool:
    spec = _spec(t)
    return dim < len(spec) and axis in shard_rules.spec_axes((spec[dim],))


def _sum_model(y: torch.Tensor) -> torch.Tensor:
    return coll.all_reduce(y, _mesh(), "model")


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
    p = _whole(p)
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
    """Over a ``model`` axis that divides ff: column-parallel ``w1``/``w3``,
    row-parallel ``w2``, then the sum over ``model``."""
    tp = _model_lanes()[0] > 1 and _sharded_on(p.w1, 1, "model")
    p = _whole(p, keep=("model",) if tp else ())
    h = x @ p.w1
    if cfg.act == "silu":
        h = F.silu(h) * (x @ p.w3)
    else:
        h = gelu(h)
    y = h @ p.w2
    return _sum_model(y) if tp else y


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


class Heads(NamedTuple):
    """The attention heads a rank computes over a ``model`` axis of m > 1
    lanes.  The H query heads split into g = gcd(H, m) groups of H/g, group
    i on the m/g lanes from i·m/g on (the reference's partitioner does the
    same with heads that do not divide m: 6 heads over 4 lanes run as 2
    groups of 3, each on 2 lanes): the rank computes the ``n_q`` heads
    from ``q0`` on, and the kv heads they read (``kv``: ids into the
    layer's kv heads, one a kv head of the rank's cache, in order).
    ``local_q`` / ``local_kv``: the rank's column shard of the query /
    kv projection holds exactly those heads.  ``out``: the rank's rows of
    the row-parallel output projection, as columns of its heads' merged
    output (all of it when ``local_q``)."""

    q0: int
    n_q: int
    kv: tuple
    local_q: bool
    local_kv: bool
    out: slice


def head_plan(n_heads: int, n_kv: int, out_dim: int) -> Heads | None:
    """This rank's ``Heads`` (``heads_at``) of an attention layer under the
    context's mesh."""
    return heads_at(n_heads, n_kv, out_dim, *_model_lanes())


def heads_at(n_heads: int, n_kv: int, out_dim: int, m: int, lane: int) -> Heads | None:
    """The ``Heads`` of lane ``lane`` of m ``model`` lanes in an attention
    layer with ``n_heads`` query and ``n_kv`` kv heads whose output
    projection has ``out_dim`` rows; None (every head, replicated) when
    m is 1, or when m does not divide ``out_dim`` (the output projection
    is then whole).  The kv heads are the lane's shard when m divides
    them; else the ones its query heads read (each query head its own kv
    head when they do not split evenly over them)."""
    if m <= 1 or out_dim % m:
        return None
    g = math.gcd(n_heads, m)
    per = m // g
    n_q = n_heads // g
    q0 = (lane // per) * n_q
    rows = out_dim // m
    out = slice((lane % per) * rows, (lane % per + 1) * rows)
    rep = n_heads // n_kv
    if n_kv % m == 0:
        kv_l = n_kv // m
        return Heads(q0, n_q, tuple(range(lane * kv_l, (lane + 1) * kv_l)), True, True, out)
    used = [(q0 + j) // rep for j in range(n_q)]
    uniq = sorted(set(used))
    if n_q % len(uniq) == 0 and used == [u for u in uniq for _ in range(n_q // len(uniq))]:
        used = uniq
    return Heads(q0, n_q, tuple(used), g == m, False, out)


def attn_heads(cfg) -> Heads | None:
    """``head_plan`` of the configuration's (GQA or cross) attention."""
    return head_plan(cfg.n_heads, cfg.n_kv_heads, cfg.n_heads * cfg.head_dim)


def _proj_heads(x: torch.Tensor, w: torch.Tensor, n_total: int, ids, local: bool):
    """(B, len(ids), S, ·): x @ the columns of heads ``ids`` of a
    projection of ``n_total`` heads.  ``local``: ``w`` is the rank's
    column shard, which holds exactly those heads.  Else, when ``w`` is
    sharded over ``model``, the product of the rank's shard is gathered
    over ``model`` and the heads picked from it (each rank computes its
    own 1/m of the projection, as the reference's partitioner does); a
    whole ``w`` gives its heads' columns first."""
    if local:
        return _split_heads(x @ w, len(ids))
    ids = list(ids)
    if not _sharded_on(w, 1, "model"):
        idx = torch.as_tensor(ids, device=w.device)
        w = w.reshape(w.shape[0], n_total, -1)[:, idx].reshape(w.shape[0], -1)
        return _split_heads(x @ w, len(ids))
    # Contiguous: the kernels read each head's row with unit stride.
    y = coll.all_gather(x @ w, _mesh(), "model", -1).contiguous()
    y = y.reshape(*y.shape[:-1], n_total, -1)
    if ids == list(range(ids[0], ids[0] + len(ids))):
        y = y[..., ids[0]:ids[0] + len(ids), :]
    else:
        y = y[..., torch.as_tensor(ids, device=y.device), :]
    return y.transpose(1, 2)


def _proj_q(x: torch.Tensor, w: torch.Tensor, n_total: int, heads: Heads | None):
    """``_proj_heads`` of the query heads of ``heads`` (every head without
    a plan)."""
    if heads is None:
        return _split_heads(x @ w, n_total)
    return _proj_heads(x, w, n_total, range(heads.q0, heads.q0 + heads.n_q), heads.local_q)


def _proj_kv(x: torch.Tensor, w: torch.Tensor, n_total: int, heads: Heads | None):
    """``_proj_heads`` of the kv heads of ``heads`` (every head without a
    plan)."""
    if heads is None:
        return _split_heads(x @ w, n_total)
    return _proj_heads(x, w, n_total, heads.kv, heads.local_kv)


def _out_proj(o: torch.Tensor, wo: torch.Tensor, heads: Heads | None) -> torch.Tensor:
    """The output projection of the merged heads ``o`` (B, S, ·): whole,
    or over this rank's rows of the row-parallel ``wo`` and summed over
    ``model``."""
    if heads is None:
        return o @ wo
    return _sum_model(o[..., heads.out] @ wo)


def gqa_qkv(cfg, p: Attention, x: torch.Tensor, positions: torch.Tensor,
            heads: Heads | None = None):
    """q, k, v of every head, or of ``heads`` (p then holds the rank's
    column shards of ``wq``/``wk``/``wv``; ``_proj_heads``)."""
    q = _proj_q(x, p.wq, cfg.n_heads, heads)
    k = _proj_kv(x, p.wk, cfg.n_kv_heads, heads)
    v = _proj_kv(x, p.wv, cfg.n_kv_heads, heads)
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
    heads = attn_heads(cfg)
    p = _head_params(p, heads)
    q, k, v = gqa_qkv(cfg, p, x, positions, heads)
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    return _out_proj(_merge_heads(o), p.wo, heads), (k, v)


def _model_shards(p, out: torch.Tensor):
    """``p``'s parameters with each leaf gathered over every axis but
    ``model`` (a leaf sharded over ``model`` stays the rank's shard);
    ``out``, its row-parallel output projection, must be sharded."""
    if not _sharded_on(out, 0, "model"):
        raise ValueError("the mesh has a model axis but the layer's parameters are not "
                         "sharded over it: build the model under the mesh "
                         "(transformer.init_params(..., pctx=))")
    return _whole(p, keep=("model",))


def _head_params(p, heads: Heads | None):
    """An attention or MLA layer's parameters as its heads need them
    (``_model_shards``); whole without a plan."""
    return _whole(p) if heads is None else _model_shards(p, p.wo)


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
    heads = attn_heads(cfg)
    p = _head_params(p, heads)
    n_q = cfg.n_heads if heads is None else heads.n_q
    q, k_new, v_new = gqa_qkv(cfg, p, x, positions, heads)
    slot = pos % s_max if ring else pos
    slot = min(max(slot, 0), s_max - 1)
    k_cache[:, :, slot] = k_new[:, :, 0]
    v_cache[:, :, slot] = v_new[:, :, 0]
    kv = k_cache.shape[1]
    rep = n_q // kv
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
    o = o.reshape(b, 1, n_q * cfg.head_dim).to(x.dtype)
    return _out_proj(o, p.wo, heads), cache


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
    cache keeps them for decode): (B, kv, Fs, hd), of the rank's kv heads
    under a ``model`` axis (``attn_heads``)."""
    heads = attn_heads(cfg)
    p = _head_params(p, heads)
    return (_proj_kv(enc_out, p.wk, cfg.n_kv_heads, heads),
            _proj_kv(enc_out, p.wv, cfg.n_kv_heads, heads))


def cross_apply(cfg, p: Attention, x: torch.Tensor, kv) -> torch.Tensor:
    """Decoder cross-attention through the flash kernel: no mask, no rope.
    In decode x holds one token, a query row against every encoder key.
    ``kv``: ``cross_kv``'s, of the rank's kv heads."""
    k, v = kv
    heads = attn_heads(cfg)
    p = _head_params(p, heads)
    o = ops.flash_attention(_proj_q(x, p.wq, cfg.n_heads, heads), k, v, causal=False)
    return _out_proj(_merge_heads(o), p.wo, heads)


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


def mla_heads(cfg) -> Heads | None:
    """The rank's ``Heads`` of an MLA layer (each head its own k and v)."""
    return head_plan(cfg.n_heads, cfg.n_heads, cfg.n_heads * cfg.v_dim_per_head)


def _split_cols(x: torch.Tensor, w: torch.Tensor, split: bool) -> torch.Tensor:
    """x @ w for a ``w`` whole on every rank; with ``split`` (and a
    ``model`` axis of m lanes that divides w's columns) each rank computes
    its 1/m of the columns and the parts are gathered over ``model``."""
    m, lane = _model_lanes()
    n = w.shape[1]
    if not split or m <= 1 or n % m:
        return x @ w
    c = n // m
    return coll.all_gather(x @ w[:, lane * c:(lane + 1) * c], _mesh(), "model", -1)


def _mla_q(cfg, p: MLA, x: torch.Tensor, positions: torch.Tensor, heads: Heads | None = None,
           split: bool = False):
    nope = cfg.qk_nope_dim
    cq = x
    if cfg.q_lora_rank:
        cq = rmsnorm(_split_cols(x, p.w_dq, split), p.q_norm, cfg.norm_eps)
    q = _proj_q(cq, p.w_uq, cfg.n_heads, heads)                 # (B,h,S,nope+rope)
    return q[..., :nope], rope(q[..., nope:], positions, cfg.rope_theta)


def _mla_ckv(cfg, p: MLA, x: torch.Tensor, positions: torch.Tensor, split: bool = False):
    r = cfg.kv_lora_rank
    dkv = _split_cols(x, p.w_dkv, split)                         # (B,S,kv_lora+rope)
    c_kv = rmsnorm(dkv[..., :r], p.kv_norm, cfg.norm_eps)
    k_rope = rope(dkv[..., r:][:, None], positions, cfg.rope_theta)  # (B,1,S,rope)
    return c_kv, k_rope


def mla_apply(cfg, p: MLA, x: torch.Tensor, *, causal: bool = True, window=None,
              positions: torch.Tensor | None = None, pad_v: bool = True,
              split_latent: bool = True):
    """Full-sequence MLA through the flash kernel at the qk head dim
    (nope + rope), scale 1/√(nope + rope).  With ``pad_v`` (the default,
    as the reference) v is padded with zeros to the qk dim and the output
    cut back to v's, so the kernel sees equal dims; without it the dims
    differ, which only the plain route takes.  Returns (out, (c_kv,
    k_rope)) so prefill can seed the latent cache.  Under a ``model``
    axis the rank computes its heads (``mla_heads``): ``w_uq``/``w_uk``/
    ``w_uv`` column-parallel, ``wo`` row-parallel, the latent c_kv and
    k_rope whole.  ``split_latent``: the replicated down-projections
    ``w_dq`` and ``w_dkv`` run split over ``model`` (``_split_cols``), as
    the reference's partitioner runs them in training and decode; prefill
    passes False, where it runs them whole on every rank."""
    b, s, _ = x.shape
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_dim_per_head
    heads = mla_heads(cfg)
    p = _head_params(p, heads)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    split = split_latent and heads is not None
    q_nope, q_rope = _mla_q(cfg, p, x, positions, heads, split)
    c_kv, k_rope = _mla_ckv(cfg, p, x, positions, split)
    k_nope = _proj_q(c_kv, p.w_uk, cfg.n_heads, heads)          # (B,h,S,nope)
    v = _proj_q(c_kv, p.w_uv, cfg.n_heads, heads)               # (B,h,S,vd)
    h = k_nope.shape[1]
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(b, h, s, rope_d)], -1)
    dq = nope + rope_d
    scale = 1.0 / math.sqrt(dq)
    if pad_v and vd < dq:
        v = F.pad(v, (0, dq - vd))
        o = ops.flash_attention(q, k, v, causal=causal, window=window, scale=scale)[..., :vd]
    else:
        o = ops.flash_attention(q, k, v, causal=causal, window=window, scale=scale)
    return _out_proj(_merge_heads(o), p.wo, heads), (c_kv, k_rope)


def _head_cols(w: torch.Tensor, n_total: int, heads: Heads | None) -> torch.Tensor:
    """(rows, n, ·): the columns of a projection of ``n_total`` heads that
    belong to the rank's heads (all of them without a plan); a whole
    ``w`` when it is not the rank's shard."""
    if heads is None:
        return w.reshape(w.shape[0], n_total, -1)
    if heads.local_q:
        return w.reshape(w.shape[0], heads.n_q, -1)
    w = gather_param(w)
    return w.reshape(w.shape[0], n_total, -1)[:, heads.q0:heads.q0 + heads.n_q]


def mla_decode(cfg, p: MLA, x: torch.Tensor, cache: dict, pos: int):
    """Absorbed MLA decode against the latent cache {"ckv": (B, S, kv_lora),
    "kr": (B, S, rope)}, updated IN PLACE at slot ``pos`` (clamped to [0,
    S − 1], as ``dynamic_update_slice_in_dim`` clamps it).  W_uk is
    absorbed into the query and W_uv applied after the weighted sum, all
    in float32 einsums, as the reference computes it; under a ``model``
    axis on the rank's heads, against the whole latent cache."""
    b = x.shape[0]
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_dim_per_head
    heads = mla_heads(cfg)
    h = cfg.n_heads if heads is None else heads.n_q
    p = _head_params(p, heads)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    split = heads is not None
    q_nope, q_rope = _mla_q(cfg, p, x, positions, heads, split)  # (B,h,1,·)
    c_new, kr_new = _mla_ckv(cfg, p, x, positions, split)        # (B,1,r) / (B,1,1,rope)
    ckv, krope = cache["ckv"], cache["kr"]
    s_max = ckv.shape[1]
    slot = min(max(pos, 0), s_max - 1)
    ckv[:, slot] = c_new[:, 0]
    krope[:, slot] = kr_new[:, 0, 0]
    q_lat = torch.einsum("bhqn,rhn->bhqr", q_nope.float(),
                         _head_cols(p.w_uk, cfg.n_heads, heads).float())   # (B,h,1,r)
    logits = (torch.einsum("bhqr,bsr->bhqs", q_lat, ckv.float())
              + torch.einsum("bhqd,bsd->bhqs", q_rope.float(), krope.float())) \
        / math.sqrt(nope + rope_d)
    mask = torch.arange(s_max, device=x.device) <= pos
    wts = torch.softmax(torch.where(mask, logits, -1e30), dim=-1)
    o_lat = torch.einsum("bhqs,bsr->bhqr", wts, ckv.float())    # (B,h,1,r)
    o = torch.einsum("bhqr,rhv->bhqv", o_lat,
                     _head_cols(p.w_uv, cfg.n_heads, heads).float())
    o = o.transpose(1, 2).reshape(b, 1, h * vd).to(x.dtype)
    return _out_proj(o, p.wo, heads), cache


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


def _route(probs: torch.Tensor, k: int, capacity: int, e_lo: int = 0,
           e_local: int | None = None) -> Routing:
    """Top-k routing with per-expert capacity, as the reference computes
    it from ``probs`` (t, E): top-k by a stable descending sort (so ties go
    to the lower expert id, as ``jax.lax.top_k``), then ``route_given``
    for the experts [e_lo, e_lo + e_local).  Needs no host sync."""
    topi = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]
    return route_given(probs, topi, capacity, e_lo, e_local)


def route_given(probs: torch.Tensor, topi: torch.Tensor, capacity: int, e_lo: int = 0,
                e_local: int | None = None) -> Routing:
    """The routing of the choice ``topi`` (t, k), best first, to the
    ``e_local`` experts from ``e_lo`` on (all E by default; an
    expert-parallel lane holds a slice): the gates are ``probs``' values
    there, their sum folded left to right; a stable argsort of the copies
    by local expert (a copy to another lane's expert sorts last), ``first``
    by a left searchsorted, and each copy's rank within its expert; copies
    ranked at or past ``capacity``, or to another lane, are dropped.
    ``idx`` inverts the slot map for ``dispatch_gather``.  (A caller may
    pass another run's ``topi`` to route by its decisions.)"""
    t, e = probs.shape
    e_local = e if e_local is None else e_local
    k = topi.shape[1]
    dev = probs.device
    topv = probs.gather(1, topi)
    total = topv[:, 0]
    for i in range(1, k):
        total = total + topv[:, i]
    gates = topv / torch.clamp_min(total, 1e-9)[:, None]
    fe = topi.reshape(-1)
    if e_local != e:
        fe = torch.where((fe >= e_lo) & (fe < e_lo + e_local), fe - e_lo, e_local)
    order = torch.argsort(fe, stable=True)
    le_s = fe[order]
    first = torch.searchsorted(le_s, torch.arange(e_local + 1, device=dev))
    rank = torch.arange(t * k, device=dev) - first[le_s]
    keep = (rank < capacity) & (le_s < e_local)
    slot = torch.where(keep, le_s * capacity + rank, e_local * capacity)
    # A dropped copy writes −1 to the spare last slot, which is cut off.
    tok = torch.where(keep, order // k, -1).to(torch.int32)
    idx = torch.full((e_local * capacity + 1,), -1, dtype=torch.int32, device=dev)
    idx = idx.scatter_(0, slot, tok)[:-1]
    return Routing(topi, gates, order, keep, slot, idx)


def _router_probs(x_flat: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    logits = (x_flat @ router).float()
    ex = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return ex / ex.sum(dim=-1, keepdim=True)                    # jax.nn.softmax


def _combine(rows: torch.Tensor, slot: torch.Tensor, gate_s: torch.Tensor,
             order: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """y (t, d): each token's k contributions ``rows[slot[c]] · gate_s[c]``
    (c its copies' positions in the sorted list) summed in the reference's
    order, ascending position, each add rounded in the rows' dtype (no
    float atomics), one contribution a token at a time."""
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(t * k, device=order.device))
    pos = inv.reshape(t, k).sort(dim=1).values
    y = rows.new_zeros((t, rows.shape[1]))
    for i in range(k):
        c = pos[:, i]
        y = y + rows[slot[c]] * gate_s[c][:, None]
    return y


def _aux_parts(e: int, topi: torch.Tensor, probs: torch.Tensor):
    """(top-1 counts (E,), prob sums (E,), t): the load-balance loss's
    parts, as sums, so that shards combine linearly."""
    # A scatter-add of ones (the dry run's fake tensors cannot run bincount,
    # whose output's length depends on the data); exact below 2**24.
    counts = probs.new_zeros((e,)).scatter_add_(0, topi[:, 0], probs.new_ones(topi.shape[:1]))
    return (counts, probs.sum(dim=0),
            torch.full((), float(probs.shape[0]), dtype=torch.float32, device=probs.device))


def _moe_local(cfg, p: MoE, x_flat: torch.Tensor, capacity: int, e_lo: int = 0,
               e_local: int | None = None):
    """Route x_flat (t, d) to the experts [e_lo, e_lo + e_local) held
    here (all E by default; p's w1/w3/w2 hold those experts).  Returns
    (y (t, d), aux parts (top-1 counts (E,), prob sums (E,), t)).

    The expert buffer xe (e_local, cap, d) is ``dispatch_gather``'s copy
    of each slot's token row (zeros where empty), the reference's gather →
    mask → scatter.  The combine sums each token's k contributions in the
    reference's order, ascending position in the expert-sorted list, each
    add rounded in x's dtype (no float atomics)."""
    t, d = x_flat.shape
    e, k = cfg.n_experts, cfg.topk
    e_local = e if e_local is None else e_local
    probs = _router_probs(x_flat, p.router)
    r = _route(probs, k, capacity, e_lo, e_local)

    ye = _expert_ffn(p, [ops.dispatch_gather(x_flat, r.idx, quant=False)[0]
                         .reshape(e_local, capacity, d)])

    gate_s = (r.gates.reshape(-1)[r.order] * r.keep).to(ye.dtype)
    y = _combine(ye, r.slot, gate_s, r.order, t, k)
    return y, _aux_parts(e, r.topi, probs)


def _expert_ffn(p, held: list) -> torch.Tensor:
    """silu(xe·w1) * (xe·w3), then ·w2, for the (E_l, cap, d) buffer xe,
    handed over as the one item of ``held`` so that no caller keeps it
    alive (serving frees it before the down projection); returns (E_l·cap
    + 1, d) with a zero last row (the slot of a dropped copy)."""
    xe = held.pop()
    n, cap, d = xe.shape
    if ops._needs_grad(xe, p.w1, p.w3, p.w2):
        # Training: the same products in the same order, out of place (the
        # buffer reuse below overwrites what autograd saves).
        h = F.silu(torch.bmm(xe, p.w1)) * torch.bmm(xe, p.w3)
        del xe
        return torch.cat([torch.bmm(h, p.w2).reshape(n * cap, d), h.new_zeros((1, d))])
    # Serving: fewer buffers alive at once: the activation in place, xe
    # released before the down projection, and ye written beside its empty
    # last row.
    h = F.silu(torch.bmm(xe, p.w1), inplace=True)
    h.mul_(torch.bmm(xe, p.w3))
    dtype = xe.dtype
    del xe
    ye = h.new_empty((n * cap + 1, d), dtype=dtype)
    torch.bmm(h, p.w2, out=ye[:-1].view(n, cap, d))
    ye[-1] = 0
    return ye


def _aux_from_parts(e: int, parts) -> torch.Tensor:
    f_sum, p_sum, t = parts
    t = torch.clamp_min(t, 1.0)
    return e * torch.sum((f_sum / t) * (p_sum / t))


class _DispatchA2A(torch.autograd.Function):
    """The a2a island's send path: B9 gathers the routed token rows into
    the (D·cap, d) send buffer (int8 rows and their scales with
    ``int8``, the wire itself), then the all-to-all over ``data`` and the
    dequantisation.  Backward (the reference's ``_i8_a2a_bwd`` and the
    gather's VJP): the cotangent quantised by rows (with ``int8``), sent
    back by all-to-all, dequantised, each slot's row added to its token's
    row."""

    @staticmethod
    def forward(ctx, x, idx, mesh, int8):
        ctx.save_for_backward(x, idx)
        ctx.args = (mesh, int8)
        d = x.shape[1]
        buf, scales = ops.dispatch_gather(x, idx, quant=int8)
        n = mesh.axis_size("data")
        if not int8:
            return coll.all_to_all_raw(buf.view(n, -1, d), mesh, "data").view(-1, d)
        q = coll.all_to_all_raw(buf.view(n, -1, d), mesh, "data").view(-1, d)
        s = coll.all_to_all_raw(scales.view(n, -1), mesh, "data").view(-1)
        return (q.to(torch.float32) * s[:, None]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.parallel import compress
        x, idx = ctx.saved_tensors
        mesh, int8 = ctx.args
        back = (compress.a2a_rows_int8(g, mesh, "data") if int8
                else coll.all_to_all_raw(g.reshape(mesh.axis_size("data"), -1, g.shape[1]),
                                         mesh, "data").view(g.shape))
        (dx,) = ops._plain_vjp("dispatch_gather",
                               lambda x_: ops.ref.dispatch_gather(x_, idx, quant=False)[0],
                               (x,), (True,), back)
        return dx, None, None, None


def dispatch_a2a(x: torch.Tensor, idx: torch.Tensor, mesh, int8: bool) -> torch.Tensor:
    """Rows ``idx`` of x (−1: a zero row) in D blocks, block i to the i-th
    ``data`` lane; returns the D blocks received, dequantised to x's
    dtype (see ``_DispatchA2A``)."""
    return _DispatchA2A.apply(x, idx, mesh, int8)


def _moe_a2a(cfg, p, x_loc: torch.Tensor, *, n_dlanes: int, tokens_sharded: bool,
             int8_wire: bool):
    """The reference's ``_moe_a2a_island`` on this rank: experts over
    ``data`` (p's w1/w3/w2 hold this lane's E/D experts and its ``model``
    slice of the expert-FFN dim) never move; the routed token copies do,
    by all-to-all over ``data`` when the tokens are sharded, and each lane
    takes the copies routed to its experts when they are replicated.
    Returns (y in x_loc's shape, summed over ``model`` — and ``data`` when
    replicated —, aux parts of the local tokens)."""
    mesh = _mesh()
    d = x_loc.shape[-1]
    e, k = cfg.n_experts, cfg.topk
    big_d = n_dlanes
    e_per = e // big_d
    t = x_loc.shape[0] * x_loc.shape[1]
    xf = x_loc.reshape(t, d)
    dev = xf.device
    probs = _router_probs(xf, p.router)
    topi = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]
    topv = probs.gather(1, topi)
    total = topv[:, 0]
    for i in range(1, k):
        total = total + topv[:, i]
    gates = topv / torch.clamp_min(total, 1e-9)[:, None]
    fe = topi.reshape(-1)
    gate_flat = gates.reshape(-1)

    if tokens_sharded:
        # dispatch: sort token-copies by destination data lane
        dest = fe // e_per
        le = fe % e_per
        order = torch.argsort(dest, stable=True)
        dest_s, le_s = dest[order], le[order]
        gate_s = gate_flat[order]
        first = torch.searchsorted(dest_s, torch.arange(big_d + 1, device=dev))
        rank = torch.arange(t * k, device=dev) - first[dest_s]
        cap = int(math.ceil(t * k / big_d * cfg.capacity_factor))
        keep = rank < cap
        slot = torch.where(keep, dest_s * cap + rank, big_d * cap)
        # B9 builds the send buffer from the slot -> token map.
        send_idx = torch.full((big_d * cap + 1,), -1, dtype=torch.int32, device=dev)
        send_idx = send_idx.scatter_(0, slot, torch.where(keep, order // k, -1)
                                     .to(torch.int32))[:-1]
        send_le = torch.full((big_d * cap + 1,), -1, dtype=torch.int64, device=dev)
        send_le = send_le.scatter_(0, slot, torch.where(keep, le_s, -1))[:-1]
        recv_x = dispatch_a2a(xf, send_idx, mesh, int8_wire)
        recv_le = coll.all_to_all_raw(send_le.view(big_d, cap), mesh, "data").view(-1)
        n_recv = big_d * cap
    else:
        # Tokens replicated over 'data' (tiny batches): every lane holds all
        # tokens and selects the copies routed to its experts.
        dlane = mesh.coords["data"]
        mine = (fe >= dlane * e_per) & (fe < (dlane + 1) * e_per)
        recv_le = torch.where(mine, fe - dlane * e_per, -1)
        recv_x = xf.repeat_interleave(k, dim=0)
        n_recv = t * k

    # group received copies by local expert; B9's second gather pass
    key2 = torch.where(recv_le >= 0, recv_le, e_per)
    order2 = torch.argsort(key2, stable=True)
    rl_s = key2[order2]
    first2 = torch.searchsorted(rl_s, torch.arange(e_per + 1, device=dev))
    rank2 = torch.arange(n_recv, device=dev) - first2[rl_s]
    cap_e = int(math.ceil(n_recv / e_per))
    keep2 = (rl_s < e_per) & (rank2 < cap_e)
    slot2 = torch.where(keep2, rl_s * cap_e + rank2, e_per * cap_e)
    idx2 = torch.full((e_per * cap_e + 1,), -1, dtype=torch.int32, device=dev)
    idx2 = idx2.scatter_(0, slot2, torch.where(keep2, order2, -1).to(torch.int32))[:-1]
    # expert compute over the local f slice: ye is partial over 'model'
    ye = _expert_ffn(p, [ops.dispatch_gather(recv_x, idx2, quant=False)[0]
                         .reshape(e_per, cap_e, d)])
    # un-group: copy j of the received rows gets its slot's output
    inv2 = torch.empty_like(order2).scatter_(0, order2, torch.arange(n_recv, device=dev))
    back = ye[slot2[inv2]]
    if tokens_sharded:
        if int8_wire:
            from repro_torch.parallel import compress
            ret = compress.int8_all_to_all(back.view(big_d, cap, d), mesh, "data")
        else:
            ret = coll.all_to_all(back.view(big_d, cap, d), mesh, "data")
        ret = torch.cat([ret.reshape(n_recv, d), ret.new_zeros((1, d))])
        y = _combine(ret, slot, (gate_s * keep).to(ret.dtype), order, t, k)
        y = coll.all_reduce(y, mesh, "model")
    else:
        w = torch.where(recv_le >= 0, gate_flat, 0.0).to(back.dtype)
        contrib = (back * w[:, None]).view(t, k, d)
        y = contrib[:, 0]
        for i in range(1, k):
            y = y + contrib[:, i]
        y = coll.all_reduce(y, mesh, ("data", "model"))
    return y.reshape(x_loc.shape), _aux_parts(e, topi, probs)


def _expert_params(p: MoE, keep) -> types.SimpleNamespace:
    """The router whole, and the experts' w1 / w3 / w2 gathered over every
    axis that shards them but ``keep`` (the island's own layout)."""
    return types.SimpleNamespace(router=gather_param(p.router),
                                 **{n: gather_param(getattr(p, n), keep)
                                    for n in ("w1", "w3", "w2")})


def moe_route(cfg) -> str:
    """The MoE layer's route under the context, as the reference chooses
    it: "local" (no mesh, a ``model`` axis of 1, or E not divisible by
    it), "a2a" (``moe_impl`` "a2a" with E divisible by ``data`` > 1 and
    the expert-FFN dim by ``model``), else "epsum"."""
    c = par.ctx()
    m = c.axis_size("experts")
    e = cfg.n_experts
    if c.mesh is None or m <= 1 or e % m:
        return "local"
    n_data = c.mesh.shape.get("data", 1)
    if c.moe_impl == "a2a" and e % n_data == 0 and n_data > 1 and cfg.expert_ff % m == 0:
        return "a2a"
    return "epsum"


def moe_apply(cfg, p: MoE, x: torch.Tensor):
    """x: (B, S, d) -> (y, aux loss), by ``moe_route``:

    local — capacity ⌈t·k / E · capacity_factor⌉ over the t = B·S tokens
            (over a mesh, of the whole batch: a sharded batch is gathered
            over the DP axes and each rank keeps its rows of y);
    epsum — each ``model`` lane routes its tokens to its E/m experts
            (capacity from the local tokens), then the sum over
            ``model``;
    a2a   — ``_moe_a2a``, its tokens sharded over the DP axes when the
            batch is, else replicated.

    The aux parts are summed over the DP axes when the batch is sharded
    over them.  The shared expert, if any, is added last (an MLP,
    column/row-parallel over ``model`` where ff divides)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.topk
    c = par.ctx()
    route = moe_route(cfg)
    sharded = c.mesh is not None and c.batch_sharded and c.dp > 1
    if route == "local":
        pw = _whole(p)
        xa = coll.all_gather(x, c.mesh, c.dp_axes, 0) if sharded else x
        t = xa.shape[0] * s
        cap = int(math.ceil(t * k / e * cfg.capacity_factor))
        y, parts = _moe_local(cfg, pw, xa.reshape(t, d), cap)
        y = y.reshape(xa.shape)
        if sharded:
            i = c.mesh.index(c.dp_axes)
            y = y[i * b:(i + 1) * b]
        aux = _aux_from_parts(e, parts)
    else:
        if route == "epsum":
            m, lane = _model_lanes()
            pw = _expert_params(p, keep=("model",))
            t = b * s
            cap = int(math.ceil(t * k / e * cfg.capacity_factor))
            y, parts = _moe_local(cfg, pw, x.reshape(t, d), cap, e_lo=lane * (e // m),
                                  e_local=e // m)
            y = _sum_model(y.reshape(x.shape))
        else:
            pw = _expert_params(p, keep=("data", "model"))
            y, parts = _moe_a2a(cfg, pw, x, n_dlanes=c.mesh.shape["data"],
                                tokens_sharded=c.batch_sharded,
                                int8_wire=c.a2a_int8)
        if sharded:
            parts = tuple(coll.all_reduce(a, c.mesh, c.dp_axes) for a in parts)
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


def mamba_lanes(cfg) -> tuple[int, int] | None:
    """(m, lane) when the rank computes its ssm_heads / m heads over a
    ``model`` axis of m > 1 lanes (m must divide the heads and 2·state),
    else None (the block whole)."""
    m, lane = _model_lanes()
    if m <= 1 or cfg.ssm_heads % m or (2 * cfg.ssm_state) % m:
        return None
    return m, lane


def _mamba_cols(cfg, m: int, lane: int, device):
    """The rank's columns of ``w_in`` (z and x of its heads, its 1/m of the
    B and C columns, dt of its heads) and its channels of the conv (x of
    its heads, its B/C part): index tensors."""
    di, st, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dl, bl, hl = di // m, 2 * st // m, h // m

    def span(start, n):
        return torch.arange(start + lane * n, start + (lane + 1) * n, device=device)

    conv = torch.cat([span(0, dl), span(di, bl)])
    return torch.cat([span(0, dl), conv + di, span(2 * di + 2 * st, hl)]), conv


def _mamba_local(cfg, p: Mamba, lanes):
    """The block's parameters as the rank uses them: ``w_in``'s columns
    and the conv's channels of ``_mamba_cols``, the per-head vectors and
    ``out_norm`` sliced to its heads, ``w_out`` its row shard (``w_in``
    gathered over ``model`` and cut head-aligned: its ``spec_for`` shard
    is a contiguous 1/m of z | x | B | C | dt, not the rank's heads)."""
    m, lane = lanes
    hl, dl = cfg.ssm_heads // m, cfg.d_inner // m
    pw = _model_shards(p, p.w_out)
    cols, conv = _mamba_cols(cfg, m, lane, p.w_in.device)
    heads = slice(lane * hl, (lane + 1) * hl)
    return types.SimpleNamespace(
        w_in=gather_param(pw.w_in)[:, cols], conv=pw.conv[:, conv],
        a_log=pw.a_log[heads], dt_bias=pw.dt_bias[heads], d_skip=pw.d_skip[heads],
        out_norm=pw.out_norm[lane * dl:(lane + 1) * dl], w_out=pw.w_out)


def _mamba_project(cfg, p: Mamba, x: torch.Tensor, lanes=None):
    """z, the conv's input (x | B | C, or on ``lanes`` the rank's x | B/C
    part) and dt (B, S, heads)."""
    m = 1 if lanes is None else lanes[0]
    dl, bl, hl = cfg.d_inner // m, 2 * cfg.ssm_state // m, cfg.ssm_heads // m
    zxbcdt = x @ p.w_in
    z = zxbcdt[..., :dl]
    xbc = zxbcdt[..., dl:2 * dl + bl]
    dt = softplus(zxbcdt[..., -hl:] + p.dt_bias)                # (B,S,h)
    return z, xbc, dt


def _mamba_bc(cfg, xbc: torch.Tensor, lanes):
    """(x, B | C) of the conv's output: on ``lanes`` the rank's x and the
    B/C parts of every lane gathered over ``model``."""
    dl = cfg.d_inner if lanes is None else cfg.d_inner // lanes[0]
    bc = xbc[..., dl:]
    if lanes is not None:
        # Contiguous: B8 reads C's last axis with unit stride.
        bc = coll.all_gather(bc, _mesh(), "model", -1).contiguous()
    return xbc[..., :dl], bc


def _mamba_ssd_inputs(cfg, p: Mamba, xv: torch.Tensor, bc: torch.Tensor, dt: torch.Tensor):
    b_, s_ = xv.shape[0], xv.shape[1]
    st, hd = cfg.ssm_state, cfg.ssm_head_dim
    h = dt.shape[-1]
    xs = xv.reshape(b_, s_, h, hd)
    bmat = bc[..., :st][:, :, None, :]                          # (B,S,1,st)
    cmat = bc[..., st:][:, :, None, :]
    a = -torch.exp(p.a_log.float())                             # (h,) < 0
    a_dt = a[None, None, :] * dt                                # (B,S,h) f32 log-decay
    b_eff = bmat.expand(b_, s_, h, st) * dt[..., None]
    c_eff = cmat.expand(b_, s_, h, st)                          # a view: no copy
    return xs, a_dt, b_eff, c_eff


def _gated_norm(cfg, y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, lanes) -> torch.Tensor:
    """rmsnorm(y · silu(z)) over d_inner; on ``lanes`` the rank's channels,
    their float32 sum of squares summed over ``model`` before the scale."""
    g = y * F.silu(z)
    if lanes is None:
        return rmsnorm(g, w, cfg.norm_eps)
    g32 = g.float()
    ss = _sum_model((g32 * g32).sum(-1, keepdim=True))
    return (g32 * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)).to(g.dtype) * w


def _mamba_out(y: torch.Tensor, w_out: torch.Tensor, lanes) -> torch.Tensor:
    out = y @ w_out
    return out if lanes is None else _sum_model(out)


def mamba_apply(cfg, p: Mamba, x: torch.Tensor, conv_state=None, return_state: bool = False):
    """Full-sequence Mamba-2 block through the SSD kernel.  Returns (out,
    cache|None); with ``return_state`` the cache {"conv", "ssm"} seeds
    decode.  Under a ``model`` axis (``mamba_lanes``) the rank computes
    its heads: its columns of the input projection, the conv on its
    channels, B and C gathered over ``model``, the SSD, skip, gate and
    final state on its heads, the norm's sum of squares over ``model``,
    and the row-parallel output projection summed over ``model``."""
    lanes = mamba_lanes(cfg)
    p = _whole(p) if lanes is None else _mamba_local(cfg, p, lanes)
    z, xbc, dt = _mamba_project(cfg, p, x, lanes)
    xbc, conv_tail = _causal_conv(xbc, p.conv, conv_state)
    xv, bc = _mamba_bc(cfg, xbc, lanes)
    xs, a_dt, b_eff, c_eff = _mamba_ssd_inputs(cfg, p, xv, bc, dt)
    y = ops.ssd_scan(xs, a_dt, b_eff, c_eff)                    # (B,S,h,hd)
    y = y + xs * p.d_skip[None, None, :, None]
    y = y.reshape(x.shape[0], x.shape[1], -1)
    out = _mamba_out(_gated_norm(cfg, y, z, p.out_norm, lanes), p.w_out, lanes)
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
    (B,h,st,hd) float32} — on ``mamba_lanes`` the rank's conv channels
    and heads — updated IN PLACE (the reference returns a new one)."""
    lanes = mamba_lanes(cfg)
    p = _whole(p) if lanes is None else _mamba_local(cfg, p, lanes)
    z, xbc, dt = _mamba_project(cfg, p, x, lanes)               # S = 1
    xbc, conv_tail = _causal_conv(xbc, p.conv, cache["conv"])
    xv, bc = _mamba_bc(cfg, xbc, lanes)
    xs, a_dt, b_eff, c_eff = _mamba_ssd_inputs(cfg, p, xv, bc, dt)
    s_prev = cache["ssm"]                                       # (B,h,st,hd)
    decay = torch.exp(a_dt[:, 0])[..., None, None]              # (B,h,1,1)
    s_new = s_prev * decay + b_eff[:, 0][..., :, None] * xs[:, 0][..., None, :]
    y = torch.einsum("bhs,bhsd->bhd", c_eff[:, 0].float(), s_new)[:, None]  # (B,1,h,hd)
    y = y + xs * p.d_skip[None, None, :, None]
    y = y.reshape(x.shape[0], 1, -1).to(x.dtype)
    y = _gated_norm(cfg, y, z, p.out_norm, lanes)
    cache["conv"].copy_(conv_tail)
    cache["ssm"].copy_(s_new)
    return _mamba_out(y, p.w_out, lanes), cache
