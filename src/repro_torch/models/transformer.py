"""The LM stack: the port of ``repro/models/transformer.py`` for every
configuration kind of ``repro.configs`` on one card: decoder-only
dense (GQA/MQA, MLA), MoE, Mamba-2 and hybrid models, the encoder-decoder
(whisper: an encoder over stub frame embeddings, cross-attention in every
decoder layer) and the VLM prefix (patch embeddings before the tokens).

Layers are organised in *pattern groups* as in the reference:
``cfg.block_pattern`` repeats ``cfg.n_groups`` times.  The model is an
``nn.Module`` (``LM``) whose tree mirrors the reference's parameter
pytree: ``embed``, ``final_norm``, ``lm_head`` (untied models),
``blocks[g]["l{i}"]`` for pattern position i of group g, and for an
encoder-decoder ``encoder[e]`` and ``enc_final_norm`` (the reference
stacks each leaf over a leading group or encoder-layer axis instead;
``params_from_jax`` converts).  The cache keeps the reference's layout:
``cache["l{i}"]`` holds each leaf stacked over groups.

Entry points: ``init_params`` (seeded random weights, on the card unless
``device="cpu"``), ``abstract_params`` (uninitialised shards: the dry
run's counterpart of the reference's ``eval_shape``), ``forward`` (the
teacher-forced oracle), ``loss_fn`` (training), ``encode``,
``init_cache``, ``prefill`` and ``decode_step``.
``decode_step`` updates the cache in place.  ``LM.tree()`` is the
parameter tree in the reference's layout (a block leaf is a
``tree.Stack`` of its per-group tensors), which the optimizer and the
checkpoint read.

Rematerialisation follows ``parallel.api.ctx().remat`` as the reference's
``_scan_blocks`` / ``encode`` do: "full" checkpoints each block group (and
each encoder layer) whole (``torch.utils.checkpoint``, non-reentrant);
"dots" is a selective checkpoint that keeps the outputs of the products
of matrices without a batch axis (``aten.mm`` / ``aten.addmm``, the
counterpart of ``checkpoint_dots_with_no_batch_dims``) and recomputes the
rest; the encoder's layers are checkpointed whole under either.

Over a mesh (``parallel.api.ctx().mesh``; explicit SPMD, one rank a mesh
position): ``init_params(..., pctx=)`` and ``params_from_jax(...,
pctx=)`` build the model with each parameter holding this rank's shard
under ``parallel.sharding.spec_for`` (a leaf at a time: no rank holds a
whole model); every other entry point takes this rank's part of the batch
(``ParallelCtx.shard_batch``: split over the DP axes, or replicated when
it does not divide) and runs under ``par.use(pctx)``.  The embedding
table and the head, (V, d) with spec (``model``, None), run
vocab-parallel: a masked lookup summed over ``model``, and logits a
vocab slice a rank (``forward``, ``prefill`` and ``decode_step`` gather
them over ``model``; ``loss_fn`` takes a vocab-parallel cross entropy
and the global mean over the DP axes).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.tree import Stack
from repro_torch.parallel import api as par
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as shard_rules

AUX_COEF = 0.01


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """norm1 + mixer (``layers.attn_init``'s module, or Mamba); with
    ``cross`` (an encoder-decoder) norm_x + cross (an ``Attention``); then
    norm2 + ffn when d_ff > 0 or the layer is MoE: an MoE layer's ffn is
    ``MoE``, another's ``MLP``."""

    def __init__(self, cfg: ModelConfig, kind: str, is_moe: bool, cross: bool, gen=None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = L.Norm(cfg, cfg.d_model, **kw)
        self.mixer = L.attn_init(cfg, gen, **kw) if kind == "attn" else L.Mamba(cfg, gen, **kw)
        if cross:
            self.norm_x = L.Norm(cfg, cfg.d_model, **kw)
            self.cross = L.attn_init(cfg, gen, cross=True, **kw)
        if cfg.d_ff > 0 or is_moe:
            self.norm2 = L.Norm(cfg, cfg.d_model, **kw)
            self.ffn = (L.MoE(cfg, gen, **kw) if is_moe
                        else L.MLP(cfg, cfg.d_model, cfg.d_ff, gen, **kw))


class EncoderBlock(nn.Module):
    """An encoder layer: norm1 + mixer (non-causal attention), norm2 + ffn
    (an MLP of d_ff)."""

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = L.Norm(cfg, cfg.d_model, **kw)
        self.mixer = L.attn_init(cfg, gen, **kw)
        self.norm2 = L.Norm(cfg, cfg.d_model, **kw)
        self.ffn = L.MLP(cfg, cfg.d_model, cfg.d_ff, gen, **kw)


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        v, d = cfg.padded_vocab, cfg.d_model
        cross = cfg.encoder_layers > 0
        self.embed = L._init(gen, (v, d), 0.02, **kw)
        self.final_norm = L.Norm(cfg, d, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = L._init(gen, (v, d), 0.02, **kw)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({f"l{i}": Block(cfg, kind, is_moe, cross, gen, **kw)
                           for i, (kind, is_moe) in enumerate(cfg.layer_kinds())})
            for _ in range(cfg.n_groups))
        if cross:
            self.encoder = nn.ModuleList(EncoderBlock(cfg, gen, **kw)
                                         for _ in range(cfg.encoder_layers))
            self.enc_final_norm = L.Norm(cfg, d, **kw)

    @property
    def head(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    def tree(self) -> dict:
        """The parameters as the reference's pytree: ``embed``,
        ``final_norm``, ``lm_head`` (untied), ``blocks`` and for an
        encoder-decoder ``encoder`` and ``enc_final_norm``; each leaf of
        ``blocks`` (``encoder``) a ``Stack`` of its groups' (layers')
        tensors."""
        out: dict = {}

        def put(d: dict, name: str, value) -> None:
            *head, last = name.split(".")
            for key in head:
                d = d.setdefault(key, {})
            d[last] = value

        for name, param in self.named_parameters():
            top = name.split(".")[0]
            if top not in ("blocks", "encoder"):
                put(out, name, param)
            elif name.split(".")[1] == "0":
                rest = name.split(".", 2)[2]
                stack = getattr(self, top)
                put(out.setdefault(top, {}), rest, Stack(
                    m.get_parameter(rest) for m in stack))
        return out


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    return dev


def ref_path(name: str) -> tuple[tuple, bool]:
    """(the reference's path of the port's parameter ``name``, is it a
    stacked leaf): ``blocks.{g}.l0.mixer.wq`` is ("blocks", "l0",
    "mixer", "wq"), stacked over the groups; ``encoder.{e}....`` over the
    encoder layers."""
    parts = name.split(".")
    if parts[0] in ("blocks", "encoder"):
        return (parts[0],) + tuple(parts[2:]), True
    return tuple(parts), False


def leaf_specs(cfg: ModelConfig, pctx) -> list[tuple[str, tuple]]:
    """[(name, spec)] of the LM's parameters in the order ``LM`` makes
    them, each spec the per-group part of ``spec_for`` of its stacked
    leaf (no rule shards the group axis of any configuration)."""
    made: list = []
    with L.recording(made):
        meta = LM(cfg, None, device="meta")
    names = {id(p): name for name, p in meta.named_parameters()}
    n_stack = {"blocks": cfg.n_groups, "encoder": cfg.encoder_layers}
    out = []
    for param in made:
        name = names[id(param)]
        path, stacked = ref_path(name)
        shape = ((n_stack[path[0]],) if stacked else ()) + tuple(param.shape)
        spec = shard_rules.spec_for(path, shape, pctx)
        if stacked:
            if spec and spec[0] is not None:
                raise NotImplementedError(f"{name}: the spec {spec} shards the stacked axis")
            spec = spec[1:]
        out.append((name, tuple(spec)))
    return out


def _build(cfg, gen, dev, dtype, pctx) -> LM:
    """The LM, sharded under ``pctx``'s mesh when it has one."""
    if pctx is None or pctx.mesh is None:
        return LM(cfg, gen, device=dev, dtype=dtype)
    specs = leaf_specs(cfg, pctx)
    with L.sharded_build([spec for _, spec in specs], pctx.mesh):
        model = LM(cfg, gen, device=dev, dtype=dtype)
    for name, spec in specs:
        if getattr(model.get_parameter(name), "spec", None) != spec:
            raise RuntimeError(f"{name}: parameters were made out of order")
    return model


def init_params(cfg: ModelConfig, gen: torch.Generator | int = 0, *, device="cuda",
                dtype=torch.float32, trainable: bool = False, pctx=None) -> LM:
    """Seeded random weights with the reference's shapes and scales:
    embeddings and the head normal·0.02, matrices normal/√fan_in (the
    output projection of attention normal/√(h·hd), the Mamba conv
    normal·0.2; the MoE router normal·0.02 and its experts as ``L.MoE``
    says), norms 1, ``a_log`` and ``dt_bias`` 0, ``d_skip`` 1.  Drawn
    in float32 from ``gen`` (a ``torch.Generator`` on ``device``, or a
    seed for one) and cast to ``dtype``.  The numbers differ from the
    reference's ``jax.random`` draws; ``params_from_jax`` carries those
    across.  ``trainable`` turns ``requires_grad`` on (training);
    serving leaves it off.  With ``pctx`` holding a mesh, each parameter
    keeps this rank's shard of the same draw (and its spec)."""
    dev = _device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    return _build(cfg, gen, dev, dtype, pctx).requires_grad_(trainable)


def abstract_params(cfg: ModelConfig, *, device="cuda", dtype=torch.float32,
                    trainable: bool = False, pctx=None) -> LM:
    """The LM with every parameter an uninitialised tensor of this rank's
    shard (its spec as ``init_params`` gives it), drawn from nothing and
    never whole: the dry run builds its model so on fake tensors, where
    the reference takes ``eval_shape`` of ``init_params``."""
    dev = _device(device)
    mesh = None if pctx is None else pctx.mesh
    model = LM(cfg, None, device="meta", dtype=dtype)
    specs = leaf_specs(cfg, pctx) if mesh is not None else \
        [(name, None) for name, _ in model.named_parameters()]
    for name, spec in specs:
        shape = tuple(model.get_parameter(name).shape)
        if spec is not None:
            shape = tuple(sl.stop - sl.start for sl in shard_rules.local_slice(shape, spec, mesh))
        param = nn.Parameter(torch.empty(shape, device=dev, dtype=dtype), requires_grad=trainable)
        if spec is not None:
            param.spec = spec
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, param)
    return model


def params_from_jax(cfg: ModelConfig, tree, *, device="cuda", trainable: bool = False,
                    pctx=None) -> LM:
    """The port's model holding the reference's parameter pytree ``tree``
    (numpy arrays: ``blocks`` stacked over groups on a leading axis, keyed
    ``l{i}``; ``encoder`` stacked over encoder layers), on ``device``, in
    the arrays' dtype (one numpy has); ``requires_grad`` as
    ``trainable``.  With ``pctx`` holding a mesh, each parameter holds this
    rank's shard of its array."""
    dev = _device(device)
    dtype = torch.from_numpy(np.empty(0, np.asarray(tree["embed"]).dtype)).dtype
    model = _build(cfg, None, dev, dtype, pctx)
    expected = {name for name, _ in model.named_parameters()}
    loaded = set()

    def put(name: str, value: np.ndarray) -> None:
        param = model.get_parameter(name)
        spec = getattr(param, "spec", None)
        if spec:
            value = value[shard_rules.local_slice(value.shape, spec, pctx.mesh)]
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
        if key in ("blocks", "encoder"):
            for g in range(cfg.n_groups if key == "blocks" else cfg.encoder_layers):
                walk(f"{key}.{g}", sub, g)
        else:
            walk(key, sub, None)
    if loaded != expected:
        raise ValueError(f"parameters not in the tree: {sorted(expected - loaded)}; "
                         f"extra: {sorted(loaded - expected)}")
    return model.requires_grad_(trainable)


# ---------------------------------------------------------------------------
# Forward (teacher-forced)
# ---------------------------------------------------------------------------


def _vocab_lanes(table: torch.Tensor) -> tuple[int, int]:
    """(vocab slices over ``model``, this rank's slice) of an embedding
    table or head; (1, 0) when it is not split."""
    if not L._sharded_on(table, 0, "model"):
        return 1, 0
    return L._model_lanes()


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, tokens, axis=0)`` with its bounds written out: an
    id in [−V, 0) counts from the end, and an id outside [−V, V) gives a
    row of NaN (jnp.take's default "fill" mode).  A table split over
    ``model`` looks up the ids of its slice (zero rows for the others) and
    sums over ``model``."""
    m, lane = _vocab_lanes(table)
    table = L.gather_param(table, keep=("model",))
    v_loc = table.shape[0]
    v = v_loc * m
    idx = torch.where(tokens < 0, tokens + v, tokens)
    ok = (idx >= 0) & (idx < v)
    if m == 1:
        rows = table[idx.clamp(0, v - 1)]
    else:
        loc = idx - lane * v_loc
        mine = (loc >= 0) & (loc < v_loc)
        rows = table[loc.clamp(0, v_loc - 1)] * mine[..., None].to(table.dtype)
        rows = L._sum_model(rows)
    return torch.where(ok[..., None], rows, torch.nan)


def _head_local(model: LM, x: torch.Tensor) -> torch.Tensor:
    """x @ head.T over this rank's vocab slice (all of it when unsplit)."""
    return x @ L.gather_param(model.head, keep=("model",)).T


def _logits(model: LM, x: torch.Tensor) -> torch.Tensor:
    """x @ head.T over the whole vocabulary (a split head's slices
    gathered over ``model``)."""
    y = _head_local(model, x)
    if _vocab_lanes(model.head)[0] > 1:
        y = coll.all_gather(y, par.ctx().mesh, "model", dim=-1)
    return y


def _ffn_apply(cfg, bp: Block, x):
    """x + the block's ffn of norm2(x), and the MoE aux loss (None for an MLP)."""
    h2 = L.norm_apply(cfg, bp.norm2, x)
    if isinstance(bp.ffn, L.MoE):
        y, aux = L.moe_apply(cfg, bp.ffn, h2)
    else:
        y, aux = L.mlp_apply(cfg, bp.ffn, h2), None
    return x + y, aux


def _mixer_apply(cfg, kind: str, bp: Block, h, positions, window, return_state: bool = False):
    """The block's mixer over the full sequence: (out, what prefill caches:
    (k, v), (c_kv, k_rope) for MLA, or the Mamba cache, which is None
    unless ``return_state``, which prefill sets)."""
    if kind != "attn":
        return L.mamba_apply(cfg, bp.mixer, h, return_state=return_state)
    if cfg.attn_kind == "mla":
        return L.mla_apply(cfg, bp.mixer, h, positions=positions, window=window,
                           split_latent=not return_state)
    return L.attn_apply(cfg, bp.mixer, h, positions=positions, window=window)


def _cross(cfg, bp: Block, x, enc_out):
    """x + the block's cross-attention of norm_x(x) over ``enc_out``, and
    the (k, v) it attended to."""
    kv = L.cross_kv(cfg, bp.cross, enc_out)
    return x + L.cross_apply(cfg, bp.cross, L.norm_apply(cfg, bp.norm_x, x), kv), kv


def _block_apply(cfg, kind: str, bp: Block, x, positions, window, enc_out=None):
    """One block, full-sequence.  Returns (x, aux or None)."""
    o, _ = _mixer_apply(cfg, kind, bp, L.norm_apply(cfg, bp.norm1, x), positions, window)
    x = x + o
    if enc_out is not None and hasattr(bp, "cross"):
        x, _ = _cross(cfg, bp, x, enc_out)
    if hasattr(bp, "ffn"):
        return _ffn_apply(cfg, bp, x)
    return x, None


def encode(cfg: ModelConfig, model: LM, frames: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over stub frame embeddings (B, Fs, d): sinusoid
    positions, then each layer's non-causal attention and MLP, then
    ``enc_final_norm``.  The frames are cast to the parameters' dtype (the
    reference promotes a mix of dtypes instead; alike when they agree)."""
    if not hasattr(model, "encoder"):
        raise ValueError(f"{cfg.name} has no encoder: frames are for an encoder-decoder")
    frames = frames.to(model.embed.dtype)
    x = frames + L.sinusoid_pos(frames.shape[1], cfg.d_model,
                                device=frames.device).to(frames.dtype)

    c = par.ctx()

    def layer(bp, x):
        with par.use(c):    # a recompute in the backward pass runs on its thread
            o, _ = L.attn_apply(cfg, bp.mixer, L.norm_apply(cfg, bp.norm1, x), causal=False)
            x = x + o
            return x + L.mlp_apply(cfg, bp.ffn, L.norm_apply(cfg, bp.norm2, x))

    remat = c.remat != "none"
    for bp in model.encoder:
        x = _ckpt.checkpoint(layer, bp, x, use_reentrant=False) if remat else layer(bp, x)
    return L.norm_apply(cfg, model.enc_final_norm, x)


def _embed_inputs(cfg, model: LM, tokens, prefix):
    """The token embeddings after the VLM ``prefix`` (B, P, d), if any (cast
    to the embeddings' dtype), with sinusoid positions where the config has
    them; and the prefix length P (0 without)."""
    x = embed_tokens(model.embed, tokens)
    offset = 0
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
        offset = prefix.shape[1]
    if cfg.pos_embed == "sinusoid":
        x = x + L.sinusoid_pos(x.shape[1], cfg.d_model, device=x.device).to(x.dtype)
    return x, offset


def forward(cfg: ModelConfig, model: LM, tokens: torch.Tensor, *, prefix=None, frames=None,
            window="cfg"):
    """Teacher-forced forward.  tokens: (B, S) int; prefix: (B, P, d) VLM
    patch embeddings before the tokens; frames: (B, Fs, d) the encoder's
    stub input (encoder-decoder only).  Returns (logits (B, S,
    padded_vocab), aux): the prefix's positions are cut off before the
    head; aux is the MoE layers' load-balance losses summed over the
    layers in order (float32; 0 without MoE)."""
    x, aux = _hidden(cfg, model, tokens, prefix, frames, window)
    return _logits(model, x), aux


def _hidden(cfg, model: LM, tokens, prefix, frames, window):
    """The final norm's output over the token positions, and the aux loss."""
    win = cfg.window if window == "cfg" else window
    x, offset = _embed_inputs(cfg, model, tokens, prefix)
    positions = torch.arange(x.shape[1], device=x.device)
    enc_out = encode(cfg, model, frames) if frames is not None else None
    kinds = cfg.layer_kinds()
    c = par.ctx()

    def group_apply(group, x, aux):
        # Under the caller's context also where a checkpoint recomputes the
        # group: the backward pass of card tensors runs on the autograd
        # engine's device thread, which does not see this thread's context.
        with par.use(c):
            for i, (kind, _) in enumerate(kinds):
                x, a = _block_apply(cfg, kind, group[f"l{i}"], x, positions, win, enc_out)
                if a is not None:
                    aux = aux + a
        return x, aux

    remat = c.remat
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for group in model.blocks:
        if remat == "none":
            x, aux = group_apply(group, x, aux)
        else:
            x, aux = _ckpt.checkpoint(group_apply, group, x, aux, use_reentrant=False,
                                      **_REMAT_KW[remat])
    return L.norm_apply(cfg, model.final_norm, x)[:, offset:], aux


def _save_dots(ctx, func, *args, **kwargs):
    """Selective-checkpoint policy of remat "dots": keep the products of
    matrices without a batch axis, recompute everything else."""
    if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_KW = {"full": {},
             "dots": {"context_fn": functools.partial(
                 _ckpt.create_selective_checkpoint_contexts, _save_dots)}}


def loss_fn(cfg: ModelConfig, model: LM, batch: dict) -> torch.Tensor:
    """Next-token cross entropy (+ ``AUX_COEF`` × the MoE aux loss), as the
    reference's ``loss_fn``: ``batch`` holds "tokens" (B, S) and, where the
    configuration takes them, "prefix" or "frames", passed to ``forward``.
    The logits are taken in float32, the padded vocabulary entries set to
    −1e30, and the mean NLL of each next token under ``log_softmax`` over
    positions [:, :-1].

    Over a mesh the batch is this rank's part and the loss the global
    mean: a head split over ``model`` takes the vocab-parallel cross
    entropy (the max, the sum of exponentials and the target's logit
    each reduced over ``model``), and a sharded batch's mean is summed
    over the DP axes (each part's mean / dp)."""
    tokens = batch["tokens"]
    c = par.ctx()
    if c.mesh is not None:
        x, aux = _hidden(cfg, model, tokens, batch.get("prefix"), batch.get("frames"), "cfg")
        nll = _vocab_parallel_nll(cfg, model, x, tokens)
        loss = nll.mean()
        if c.batch_sharded and c.dp > 1:
            loss = coll.all_reduce(loss / c.dp, c.mesh, c.dp_axes)
        return loss + AUX_COEF * aux
    logits, aux = forward(cfg, model, tokens, prefix=batch.get("prefix"),
                          frames=batch.get("frames"))
    logits = logits.float()
    if cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
        logits = torch.where(pad, -1e30, logits)
    targets = tokens[:, 1:].long()
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -lp.gather(-1, targets[..., None])[..., 0]
    return nll.mean() + AUX_COEF * aux


def _vocab_parallel_nll(cfg, model: LM, x: torch.Tensor, tokens: torch.Tensor):
    """Each next token's NLL (B, S − 1) from this rank's vocab slice of
    the logits (float32, the padded entries −1e30): logsumexp as max +
    log Σ exp, both reduced over ``model``, minus the target's logit
    (summed over ``model`` from the slice that holds it)."""
    mesh = par.ctx().mesh
    m, lane = _vocab_lanes(model.head)
    axes = "model" if m > 1 else ()
    logits = _head_local(model, x[:, :-1]).float()
    v_loc = logits.shape[-1]
    lo = lane * v_loc
    if cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(lo, lo + v_loc, device=logits.device) >= cfg.vocab
        logits = torch.where(pad, -1e30, logits)
    mx = coll.all_reduce_max(logits.amax(dim=-1), mesh, axes)
    se = coll.all_reduce(torch.exp(logits - mx[..., None]).sum(dim=-1), mesh, axes)
    loc = tokens[:, 1:].long() - lo
    mine = (loc >= 0) & (loc < v_loc)
    picked = logits.gather(-1, loc.clamp(0, v_loc - 1)[..., None])[..., 0]
    tgt = coll.all_reduce(torch.where(mine, picked, 0.0), mesh, axes)
    return torch.log(se) + mx - tgt


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def _cache_len(cfg, max_len: int, window) -> int:
    win = cfg.window if window == "cfg" else window
    return min(max_len, win) if win else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.float32,
               window="cfg", *, device="cuda", frontend_seq: int | None = None) -> dict:
    """Zeroed cache: ``cache["l{i}"]`` holds, stacked over groups, {"k",
    "v"} (g, batch, kv, S, hd) for attention, {"ckv"} (g, batch, S,
    kv_lora) and {"kr"} (g, batch, S, rope) for MLA, {"conv"} (g, batch,
    K−1, C) and {"ssm"} (g, batch, h, st, hd) for Mamba, and for an
    encoder-decoder {"xk", "xv"} (g, batch, kv, Fs, hd), the
    cross-attention's keys and values over ``frontend_seq`` frames (the
    config's by default).  The SSM state is float32 whatever ``dtype``.
    Under a mesh with a ``model`` axis, "k"/"v" and "xk"/"xv" hold the
    kv heads the rank reads (``layers.attn_heads``), "conv" and "ssm" its
    channels and heads (``layers.mamba_lanes``: (K−1, C/m) and (h/m, st,
    hd)); MLA's latent cache stays whole (every local head reads all of
    it)."""
    dev = _device(device)
    g = cfg.n_groups
    heads = L.attn_heads(cfg)
    n_kv = cfg.n_kv_heads if heads is None else len(heads.kv)
    lanes = L.mamba_lanes(cfg) if cfg.ssm_state else None
    m = 1 if lanes is None else lanes[0]
    s = _cache_len(cfg, max_len, window)
    fs = frontend_seq or cfg.frontend_seq

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    cache: dict = {}
    for i, (kind, _) in enumerate(cfg.layer_kinds()):
        if kind == "attn" and cfg.attn_kind == "mla":
            c = {"ckv": zeros(g, batch, s, cfg.kv_lora_rank),
                 "kr": zeros(g, batch, s, cfg.qk_rope_dim)}
        elif kind == "attn":
            c = {"k": zeros(g, batch, n_kv, s, cfg.head_dim),
                 "v": zeros(g, batch, n_kv, s, cfg.head_dim)}
        else:
            c = {"conv": zeros(g, batch, cfg.conv_kernel - 1,
                               (cfg.d_inner + 2 * cfg.ssm_state) // m),
                 "ssm": zeros(g, batch, cfg.ssm_heads // m, cfg.ssm_state, cfg.ssm_head_dim,
                              dt=torch.float32)}
        if cfg.encoder_layers:
            c["xk"] = zeros(g, batch, n_kv, fs, cfg.head_dim)
            c["xv"] = zeros(g, batch, n_kv, fs, cfg.head_dim)
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
    if kind == "attn" and cfg.attn_kind == "mla":
        o, _ = L.mla_decode(cfg, bp.mixer, h, cache_slice, pos)
    elif kind == "attn":
        o, _ = L.attn_decode(cfg, bp.mixer, h, cache_slice, pos, window=window, ring=ring)
    else:
        o, _ = L.mamba_decode(cfg, bp.mixer, h, cache_slice, pos)
    x = x + o
    if hasattr(bp, "cross"):
        hx = L.norm_apply(cfg, bp.norm_x, x)
        x = x + L.cross_apply(cfg, bp.cross, hx, (cache_slice["xk"], cache_slice["xv"]))
    if hasattr(bp, "ffn"):
        x, _ = _ffn_apply(cfg, bp, x)
    return x


def decode_step(cfg: ModelConfig, model: LM, token: torch.Tensor, cache: dict, pos,
                window="cfg"):
    """One decode step.  token: (B, 1) int; pos: the absolute position being
    written (int or 0-d tensor; after a VLM prefix it counts the prefix).
    Returns (logits (B, V), cache); the cache is updated in place and
    returned."""
    pos = int(pos)
    kinds = cfg.layer_kinds()
    win = cfg.window if window == "cfg" else window
    # Ring-buffer mode: a windowed cache shorter than the position range.
    s_cache = None
    for i, (kind, _) in enumerate(kinds):
        if kind == "attn" and cfg.attn_kind != "mla":
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
    logits = _logits(model, x)[:, 0]
    return logits, cache


def prefill(cfg: ModelConfig, model: LM, tokens: torch.Tensor, *, prefix=None, frames=None,
            max_len: int | None = None, window="cfg"):
    """Process the prompt (after the VLM ``prefix``, if any), returning
    (last-token logits, cache, next_pos); next_pos counts the prefix.

    Runs the full-sequence forward (the flash, SSD and MoE gather kernels
    on the card; an encoder-decoder first encodes ``frames``, which it
    needs) and writes K/V (the latent c_kv and k_rope for MLA, the conv
    tail and SSM state for Mamba, and each layer's cross-attention K/V)
    into a fresh cache of length ``max_len`` (defaults to the prompt's
    token count, as in the reference), each leaf cast to the cache's
    dtype: the parameters' for all but the float32 SSM state.  The cross
    K/V leaves take the frames' length."""
    b, s = tokens.shape
    win = cfg.window if window == "cfg" else window
    max_len = max_len or s
    if cfg.encoder_layers and frames is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder's prefill needs frames")
    kinds = cfg.layer_kinds()
    enc_out = encode(cfg, model, frames) if frames is not None else None
    cache = init_cache(cfg, b, max_len, dtype=model.embed.dtype, window=window,
                       device=model.embed.device,
                       frontend_seq=enc_out.shape[1] if enc_out is not None else None)
    s_cache = _cache_len(cfg, max_len, window)
    x, _ = _embed_inputs(cfg, model, tokens, prefix)
    s_total = x.shape[1]
    positions = torch.arange(s_total, device=x.device)
    for g, group in enumerate(model.blocks):
        for i, (kind, _) in enumerate(kinds):
            bp, c = group[f"l{i}"], cache[f"l{i}"]
            o, out = _mixer_apply(cfg, kind, bp, L.norm_apply(cfg, bp.norm1, x), positions,
                                  win, return_state=True)
            if kind != "attn":
                c["conv"][g].copy_(out["conv"])
                c["ssm"][g].copy_(out["ssm"])
            elif cfg.attn_kind == "mla":
                c["ckv"][g].copy_(_fit(out[0], s_cache, axis=1))
                c["kr"][g].copy_(_fit(out[1][:, 0], s_cache, axis=1))
            else:
                c["k"][g].copy_(_fit(out[0], s_cache, axis=2))
                c["v"][g].copy_(_fit(out[1], s_cache, axis=2))
            x = x + o
            del o, out      # not alive beside the ffn's buffers
            if enc_out is not None and hasattr(bp, "cross"):
                x, (xk, xv) = _cross(cfg, bp, x, enc_out)
                c["xk"][g].copy_(xk)
                c["xv"][g].copy_(xv)
            if hasattr(bp, "ffn"):
                x, _ = _ffn_apply(cfg, bp, x)
    x = L.norm_apply(cfg, model.final_norm, x)
    logits = _logits(model, x[:, -1])
    return logits, cache, s_total
