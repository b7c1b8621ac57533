"""The LM stack's serving path: the port of ``repro/models/transformer.py``
for decoder-only dense (GQA/MQA), MoE and Mamba-2 models, on one card.

Layers are organised in *pattern groups* as in the reference:
``cfg.block_pattern`` repeats ``cfg.n_groups`` times.  The model is an
``nn.Module`` (``LM``) whose tree mirrors the reference's parameter
pytree: ``embed``, ``final_norm``, ``lm_head`` (untied models), and
``blocks[g]["l{i}"]`` for pattern position i of group g (the reference
stacks each leaf over a leading group axis instead; ``params_from_jax``
converts).  The cache keeps the reference's layout: ``cache["l{i}"]``
holds each leaf stacked over groups.

Entry points: ``init_params`` (seeded random weights, on the card unless
``device="cpu"``), ``forward`` (the teacher-forced oracle), ``init_cache``,
``prefill`` and ``decode_step``.  ``decode_step`` updates the cache in
place.  MLA, encoder-decoder and prefix (VLM) configurations raise
``NotImplementedError``: they are later slices of the port (ROADMAP A10).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

# What each configuration kind this slice does not run waits for (ROADMAP A10).
_NOT_YET = (
    (lambda c: c.attn_kind == "mla", "MLA (mla_apply/mla_decode)", "A10 left item 2"),
    (lambda c: c.encoder_layers > 0, "the encoder and cross-attention (whisper)",
     "A10 left item 3"),
    (lambda c: c.prefix_len > 0, "the VLM prefix", "A10 left item 4"),
)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration the port's serving
    path does not run yet, naming the ROADMAP item that will port it."""
    for test, what, item in _NOT_YET:
        if test(cfg):
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet (ROADMAP {item})")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """norm1 + mixer (Attention or Mamba), then norm2 + ffn when d_ff > 0
    or the layer is MoE: an MoE layer's ffn is ``MoE``, another's ``MLP``."""

    def __init__(self, cfg: ModelConfig, kind: str, is_moe: bool, gen=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = L.Norm(cfg, cfg.d_model, **kw)
        self.mixer = L.Attention(cfg, gen, **kw) if kind == "attn" else L.Mamba(cfg, gen, **kw)
        if cfg.d_ff > 0 or is_moe:
            self.norm2 = L.Norm(cfg, cfg.d_model, **kw)
            self.ffn = (L.MoE(cfg, gen, **kw) if is_moe
                        else L.MLP(cfg, cfg.d_model, cfg.d_ff, gen, **kw))


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        check_supported(cfg)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        v, d = cfg.padded_vocab, cfg.d_model
        self.embed = L._init(gen, (v, d), 0.02, **kw)
        self.final_norm = L.Norm(cfg, d, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = L._init(gen, (v, d), 0.02, **kw)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({f"l{i}": Block(cfg, kind, is_moe, gen, **kw)
                           for i, (kind, is_moe) in enumerate(cfg.layer_kinds())})
            for _ in range(cfg.n_groups))

    @property
    def head(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.lm_head


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    return dev


def init_params(cfg: ModelConfig, gen: torch.Generator | int = 0, *, device="cuda",
                dtype=torch.float32) -> LM:
    """Seeded random weights with the reference's shapes and scales:
    embeddings and the head normal·0.02, matrices normal/√fan_in (the
    output projection of attention normal/√(h·hd), the Mamba conv
    normal·0.2; the MoE router normal·0.02 and its experts as ``L.MoE``
    says), norms 1, ``a_log`` and ``dt_bias`` 0, ``d_skip`` 1.  Drawn
    in float32 from ``gen`` (a ``torch.Generator`` on ``device``, or a
    seed for one) and cast to ``dtype``.  The numbers differ from the
    reference's ``jax.random`` draws; ``params_from_jax`` carries those
    across."""
    dev = _device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    return LM(cfg, gen, device=dev, dtype=dtype)


def params_from_jax(cfg: ModelConfig, tree, *, device="cuda") -> LM:
    """The port's model holding the reference's parameter pytree ``tree``
    (numpy arrays: ``blocks`` stacked over groups on a leading axis, keyed
    ``l{i}``), on ``device``, in the arrays' dtype (one numpy has)."""
    dev = _device(device)
    dtype = torch.from_numpy(np.empty(0, np.asarray(tree["embed"]).dtype)).dtype
    model = LM(cfg, None, device=dev, dtype=dtype)
    expected = {name for name, _ in model.named_parameters()}
    loaded = set()

    def put(name: str, value: np.ndarray) -> None:
        param = model.get_parameter(name)
        if tuple(param.shape) != value.shape:
            raise ValueError(f"{name}: shape {value.shape} != {tuple(param.shape)}")
        param.data = torch.as_tensor(np.array(value), device=dev).to(param.dtype)
        loaded.add(name)

    def walk(prefix: str, node, group: int | None) -> None:
        if isinstance(node, dict):
            for key, sub in node.items():
                walk(f"{prefix}.{key}" if prefix else key, sub, group)
        else:
            arr = np.asarray(node)
            put(prefix, arr[group] if group is not None else arr)

    for key, sub in tree.items():
        if key == "blocks":
            for g in range(cfg.n_groups):
                walk(f"blocks.{g}", sub, g)
        else:
            walk(key, sub, None)
    if loaded != expected:
        raise ValueError(f"parameters not in the tree: {sorted(expected - loaded)}; "
                         f"extra: {sorted(loaded - expected)}")
    return model


# ---------------------------------------------------------------------------
# Forward (teacher-forced)
# ---------------------------------------------------------------------------


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, tokens, axis=0)`` with its bounds written out: an
    id in [−V, 0) counts from the end, and an id outside [−V, V) gives a
    row of NaN (jnp.take's default "fill" mode)."""
    v = table.shape[0]
    idx = torch.where(tokens < 0, tokens + v, tokens)
    ok = (idx >= 0) & (idx < v)
    rows = table[idx.clamp(0, v - 1)]
    return torch.where(ok[..., None], rows, torch.nan)


def _ffn_apply(cfg, bp: Block, x):
    """x + the block's ffn of norm2(x), and the MoE aux loss (None for an MLP)."""
    h2 = L.norm_apply(cfg, bp.norm2, x)
    if isinstance(bp.ffn, L.MoE):
        y, aux = L.moe_apply(cfg, bp.ffn, h2)
    else:
        y, aux = L.mlp_apply(cfg, bp.ffn, h2), None
    return x + y, aux


def _block_apply(cfg, kind: str, bp: Block, x, positions, window):
    """One block, full-sequence.  Returns (x, aux or None)."""
    h = L.norm_apply(cfg, bp.norm1, x)
    if kind == "attn":
        o, _ = L.attn_apply(cfg, bp.mixer, h, positions=positions, window=window)
    else:
        o, _ = L.mamba_apply(cfg, bp.mixer, h)
    x = x + o
    if hasattr(bp, "ffn"):
        return _ffn_apply(cfg, bp, x)
    return x, None


def forward(cfg: ModelConfig, model: LM, tokens: torch.Tensor, *, window="cfg"):
    """Teacher-forced forward.  tokens: (B, S) int.  Returns (logits (B, S,
    padded_vocab), aux): aux is the MoE layers' load-balance losses summed
    over the layers in order (float32; 0 without MoE)."""
    win = cfg.window if window == "cfg" else window
    x = embed_tokens(model.embed, tokens)
    s = x.shape[1]
    if cfg.pos_embed == "sinusoid":
        x = x + L.sinusoid_pos(s, cfg.d_model, device=x.device).to(x.dtype)
    positions = torch.arange(s, device=x.device)
    kinds = cfg.layer_kinds()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for group in model.blocks:
        for i, (kind, _) in enumerate(kinds):
            x, a = _block_apply(cfg, kind, group[f"l{i}"], x, positions, win)
            if a is not None:
                aux = aux + a
    x = L.norm_apply(cfg, model.final_norm, x)
    logits = x @ model.head.T
    return logits, aux


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def _cache_len(cfg, max_len: int, window) -> int:
    win = cfg.window if window == "cfg" else window
    return min(max_len, win) if win else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
               window="cfg", *, device="cuda") -> dict:
    """Zeroed cache: ``cache["l{i}"]`` holds, stacked over groups, {"k",
    "v"} (g, batch, kv, S, hd) for attention, {"conv"} (g, batch, K−1, C)
    and {"ssm"} (g, batch, h, st, hd) for Mamba.  The SSM state is float32
    whatever ``dtype``."""
    check_supported(cfg)
    dev = _device(device)
    g = cfg.n_groups
    s = _cache_len(cfg, max_len, window)
    cache: dict = {}
    for i, (kind, _) in enumerate(cfg.layer_kinds()):
        if kind == "attn":
            shape = (g, batch, cfg.n_kv_heads, s, cfg.head_dim)
            c = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
        else:
            conv_dim = cfg.d_inner + 2 * cfg.ssm_state
            c = {"conv": torch.zeros((g, batch, cfg.conv_kernel - 1, conv_dim), dtype=dtype,
                                     device=dev),
                 "ssm": torch.zeros((g, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                                    dtype=torch.float32, device=dev)}
        cache[f"l{i}"] = c
    return cache


def _fit(x: torch.Tensor, target_len: int, axis: int) -> torch.Tensor:
    """Pad (with zeros, right) or keep the trailing window of ``x`` along
    ``axis`` so it matches the cache length."""
    s = x.shape[axis]
    if s == target_len:
        return x
    if s > target_len:  # windowed cache: keep the last target_len entries
        return x.narrow(axis, s - target_len, target_len)
    pad = [0, 0] * (x.dim() - 1 - axis) + [0, target_len - s]
    return torch.nn.functional.pad(x, pad)


def _block_decode(cfg, kind: str, bp: Block, x, cache_slice: dict, pos: int, window=None,
                  ring: bool = False):
    h = L.norm_apply(cfg, bp.norm1, x)
    if kind == "attn":
        o, _ = L.attn_decode(cfg, bp.mixer, h, cache_slice, pos, window=window, ring=ring)
    else:
        o, _ = L.mamba_decode(cfg, bp.mixer, h, cache_slice, pos)
    x = x + o
    if hasattr(bp, "ffn"):
        x, _ = _ffn_apply(cfg, bp, x)
    return x


def decode_step(cfg: ModelConfig, model: LM, token: torch.Tensor, cache: dict, pos,
                window="cfg"):
    """One decode step.  token: (B, 1) int; pos: the absolute position being
    written (int or 0-d tensor).  Returns (logits (B, V), cache); the cache
    is updated in place and returned."""
    pos = int(pos)
    kinds = cfg.layer_kinds()
    win = cfg.window if window == "cfg" else window
    # Ring-buffer mode: a windowed cache shorter than the position range.
    s_cache = None
    for i, (kind, _) in enumerate(kinds):
        if kind == "attn":
            s_cache = cache[f"l{i}"]["k"].shape[3]
            break
    ring = win is not None and s_cache is not None and s_cache == win
    x = embed_tokens(model.embed, token)
    if cfg.pos_embed == "sinusoid":
        half = cfg.d_model // 2
        freqs = 1.0 / (10000 ** (2.0 * torch.arange(half, dtype=torch.float32,
                                                     device=x.device) / cfg.d_model))
        ang = torch.tensor(pos, dtype=torch.float32, device=x.device) * freqs
        x = x + torch.cat([torch.sin(ang), torch.cos(ang)]).to(x.dtype)
    for g, group in enumerate(model.blocks):
        for i, (kind, _) in enumerate(kinds):
            csl = {key: t[g] for key, t in cache[f"l{i}"].items()}
            x = _block_decode(cfg, kind, group[f"l{i}"], x, csl, pos, window=win, ring=ring)
    x = L.norm_apply(cfg, model.final_norm, x)
    logits = (x @ model.head.T)[:, 0]
    return logits, cache


def prefill(cfg: ModelConfig, model: LM, tokens: torch.Tensor, *, max_len: int | None = None,
            window="cfg"):
    """Process the prompt, returning (last-token logits, cache, next_pos).

    Runs the full-sequence forward (the flash, SSD and MoE gather kernels on the card)
    and writes K/V (or the conv tail and SSM state) into a fresh cache of
    length ``max_len`` (defaults to the prompt length), each leaf cast to
    the cache's dtype: the parameters' for K/V and conv, float32 for the
    SSM state."""
    b, s = tokens.shape
    win = cfg.window if window == "cfg" else window
    max_len = max_len or s
    kinds = cfg.layer_kinds()
    cache = init_cache(cfg, b, max_len, dtype=model.embed.dtype, window=window,
                       device=model.embed.device)
    s_cache = _cache_len(cfg, max_len, window)
    x = embed_tokens(model.embed, tokens)
    if cfg.pos_embed == "sinusoid":
        x = x + L.sinusoid_pos(s, cfg.d_model, device=x.device).to(x.dtype)
    positions = torch.arange(s, device=x.device)
    for g, group in enumerate(model.blocks):
        for i, (kind, _) in enumerate(kinds):
            bp, c = group[f"l{i}"], cache[f"l{i}"]
            h = L.norm_apply(cfg, bp.norm1, x)
            if kind == "attn":
                o, (k, v) = L.attn_apply(cfg, bp.mixer, h, positions=positions, window=win)
                c["k"][g].copy_(_fit(k, s_cache, axis=2))
                c["v"][g].copy_(_fit(v, s_cache, axis=2))
            else:
                o, mc = L.mamba_apply(cfg, bp.mixer, h, return_state=True)
                c["conv"][g].copy_(mc["conv"])
                c["ssm"][g].copy_(mc["ssm"])
            x = x + o
            if hasattr(bp, "ffn"):
                x, _ = _ffn_apply(cfg, bp, x)
    x = L.norm_apply(cfg, model.final_norm, x)
    logits = x[:, -1] @ model.head.T
    return logits, cache, s
