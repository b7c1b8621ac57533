"""Optimizers + LR schedules: the port of the reference package's
``train/optimizer.py`` (no optimizer library: plain tensors).

* adamw     — default.  Moments in float32.
* adafactor — factored second moments for leaves of ndim >= 2 (``vr`` over
              the last axis, ``vc`` over the one before it) and the RMS
              update clip; the reference's memory answer for configurations
              whose Adam state does not fit.  bf16 params may take
              stochastic rounding.
* sgdm      — baseline.

Trees are the reference's pytrees as the port holds them (``models/tree.py``):
nested dicts of tensors, or an object with ``tree()`` (the LM), where a
``Stack`` is one stacked leaf of the reference.  Leaves are visited in the
reference's flatten order.  AdamW and SGD-momentum are elementwise and
update a stacked leaf a group at a time; Adafactor reads a stacked leaf
whole (its moments and RMS clip span the stack), so its state has the
reference's stacked shapes.  Updates are computed in float32 and cast to
the parameter's dtype.

Unlike the reference's pure update, ``apply_updates`` writes the new
parameters and moments IN PLACE, a tensor at a time, so that no second
copy of a model sits on the card; it returns the same objects.

``_stochastic_round_to`` takes its uniforms from a ``torch.Generator`` (or
as a tensor): the reference's ``jax.random`` draws cannot be reproduced, so
given the same uniforms the two round alike, bit for bit.

Over a mesh (``parallel.api.ctx().mesh``) each rank holds its shard of
every leaf (a parameter's ``spec``; the moments take their parameter's,
Adafactor's ``vr`` / ``vc`` its spec less the reduced axis) and the
reductions that cross shards are summed over the axes that shard the
leaf: ``global_norm`` (a replicated leaf counted once), Adafactor's row
and column means, the mean of ``vr`` and the update RMS.  AdamW and SGD
are elementwise on the shards.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.tree import Stack, flatten, tree_map
from repro_torch.parallel import api as par
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as shard_rules


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup: int = 100
    decay_steps: int = 10_000
    schedule: str = "cosine"        # "cosine" | "linear" | "const"
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # adafactor
    factored_threshold: int = 2
    stochastic_rounding: bool = False


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (float32, on the step's device)."""
    step = _f32(step, step.device if isinstance(step, torch.Tensor) else None)
    warm = torch.clamp_max(step / max(cfg.warmup, 1), 1.0)
    t = torch.clamp((step - cfg.warmup) / max(cfg.decay_steps - cfg.warmup, 1), 0, 1)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_frac) * t
    else:
        decay = _f32(1.0, step.device)
    return cfg.lr * warm * decay


def _tensors(leaf) -> tuple:
    return tuple(leaf) if isinstance(leaf, Stack) else (leaf,)


def leaf_spec(leaf) -> tuple:
    """The spec of a leaf in the reference's (stacked) layout: a tensor's
    ``spec``, a ``Stack``'s with None for its group axis; () when the leaf
    carries none (replicated)."""
    spec = getattr(_tensors(leaf)[0], "spec", None)
    if not spec:
        return ()
    return ((None,) + tuple(spec)) if isinstance(leaf, Stack) else tuple(spec)


def _with_spec(t: torch.Tensor, spec) -> torch.Tensor:
    if spec:
        t.spec = tuple(spec)
    return t


def global_norm(tree, specs=None) -> torch.Tensor:
    """√(Σ g²) over every leaf.  Over a mesh each leaf's shard sum is
    summed over the axes its spec (from ``specs``, one a leaf in flatten
    order, else the leaf's own) shards it on, so a replicated leaf counts
    once."""
    mesh = par.ctx().mesh
    flat = [leaf for _, leaf in flatten(tree)]
    if mesh is None:
        total = 0
        for leaf in flat:
            for t in _tensors(leaf):
                total = total + torch.sum(t.float() ** 2)
        return torch.sqrt(total)
    specs = specs if specs is not None else [leaf_spec(leaf) for leaf in flat]
    parts: dict = {}
    for leaf, spec in zip(flat, specs):
        axes = shard_rules.spec_axes(spec)
        for t in _tensors(leaf):
            parts[axes] = parts.get(axes, 0) + torch.sum(t.float() ** 2)
    total = 0
    for axes in sorted(parts):
        total = total + coll.all_reduce_raw(parts[axes], mesh, axes)
    return torch.sqrt(total)


def clip_by_norm(tree, max_norm):
    g = global_norm(tree)
    scale = torch.clamp_max(max_norm / torch.clamp_min(g, 1e-9), 1.0)

    def one(leaf):
        if isinstance(leaf, Stack):
            return Stack(t * scale.to(t.dtype) for t in leaf)
        return leaf * scale.to(leaf.dtype)

    return tree_map(one, tree), g


# ---------------------------------------------------------------------------


def _zeros(leaf):
    def one(t):
        return _with_spec(torch.zeros(t.shape, dtype=torch.float32, device=t.device),
                          getattr(t, "spec", None))
    if isinstance(leaf, Stack):
        return Stack(one(t) for t in leaf)
    return one(leaf)


def init_state(cfg: OptConfig, params) -> dict:
    if cfg.name == "adamw":
        return {"m": tree_map(_zeros, params), "v": tree_map(_zeros, params)}
    if cfg.name == "adafactor":
        def fact(p):
            shape, dev = tuple(p.shape), _tensors(p)[0].device
            spec = leaf_spec(p)
            spec = spec + (None,) * (len(shape) - len(spec)) if spec else ()
            if len(shape) >= cfg.factored_threshold and len(shape) >= 2:
                return {"vr": _with_spec(torch.zeros(shape[:-1], dtype=torch.float32,
                                                     device=dev), spec[:-1]),
                        "vc": _with_spec(torch.zeros(shape[:-2] + shape[-1:],
                                                     dtype=torch.float32, device=dev),
                                         spec[:-2] + spec[-1:])}
            return {"v": _with_spec(torch.zeros(shape, dtype=torch.float32, device=dev), spec)}
        return {"f": tree_map(fact, params)}
    if cfg.name == "sgdm":
        return {"m": tree_map(_zeros, params)}
    raise ValueError(cfg.name)


def _bf16_neighbor(down: torch.Tensor, toward_up: torch.Tensor) -> torch.Tensor:
    """Adjacent bf16 value in the given direction (bit-level nextafter —
    float32 nextafter would round back to the same bf16), on the 16 bits."""
    bits = down.view(torch.int16).to(torch.int32) & 0xFFFF
    positive = (bits & 0x8000) == 0
    inc = torch.where(positive == toward_up, 1, 0xFFFF)
    stepped = (bits + inc) & 0xFFFF
    # ±0 special case: step into the smallest (sub)normal of the right sign.
    is_zero = (bits & 0x7FFF) == 0
    stepped = torch.where(is_zero, torch.where(toward_up, 0x0001, 0x8001), stepped)
    stepped = torch.where(stepped >= 0x8000, stepped - 0x10000, stepped)
    return stepped.to(torch.int16).view(torch.bfloat16)


def _stochastic_round_to(x32: torch.Tensor, dtype, key) -> torch.Tensor:
    """x32 rounded to ``dtype``; to bfloat16 stochastically: to the farther
    of the two bf16 neighbours with probability proportional to the
    distance from the nearer.  ``key``: a ``torch.Generator`` to draw the
    uniforms from, or the uniforms (x32's shape, float32 in [0, 1))."""
    if dtype != torch.bfloat16:
        return x32.to(dtype)
    down = x32.to(torch.bfloat16)            # round-to-nearest anchor
    down32 = down.float()
    toward_up = x32 > down32
    other = _bf16_neighbor(down, toward_up)  # bracket x32 between bf16s
    other32 = other.float()
    span = torch.abs(other32 - down32)
    pfar = torch.where(span > 0, torch.abs(x32 - down32) / torch.clamp_min(span, 1e-45), 0.0)
    if isinstance(key, torch.Tensor):
        u = key.to(device=x32.device, dtype=torch.float32)
    else:
        u = torch.rand(x32.shape, generator=key, device=x32.device)
    return torch.where(u < pfar, other, down)


def _write(dst: torch.Tensor, value: torch.Tensor) -> None:
    with torch.no_grad():
        dst.copy_(value)


def _stacked(leaf) -> torch.Tensor:
    """A leaf as one float32 tensor of the reference's stacked shape (a
    view where it can be: a one-group stack is its tensor unsqueezed)."""
    if not isinstance(leaf, Stack):
        return leaf.float()
    if len(leaf) == 1:
        return leaf[0].float().unsqueeze(0)
    return torch.stack([t.float() for t in leaf])


def apply_updates(cfg: OptConfig, grads, state, params, step, key=None):
    """One update of ``params`` (a tree) by ``grads`` (the same tree's
    gradients), in place.  Returns (params, state, metrics) with metrics
    {"gnorm", "lr"} (float32 tensors); ``key``: the Adafactor stochastic
    rounding's ``torch.Generator`` (seeded 0 on the parameters' device by
    default) or a list of uniforms, one a leaf in flatten order."""
    flat_p = [leaf for _, leaf in flatten(params)]
    specs = [leaf_spec(leaf) for leaf in flat_p]
    gnorm = global_norm(grads, specs)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = lr_at(cfg, step)
    t = _f32(step, lr.device) + 1.0
    flat_g = [leaf for _, leaf in flatten(grads)]
    if len(flat_g) != len(flat_p):
        raise ValueError(f"{len(flat_g)} gradient leaves for {len(flat_p)} parameters")

    def clipped(g: torch.Tensor) -> torch.Tensor:
        return g.float() * scale

    if cfg.name == "adamw":
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        flat_m = [leaf for _, leaf in flatten(state["m"])]
        flat_v = [leaf for _, leaf in flatten(state["v"])]
        for pl, gl, ml, vl in zip(flat_p, flat_g, flat_m, flat_v):
            for p, g, m, v in zip(_tensors(pl), _tensors(gl), _tensors(ml), _tensors(vl)):
                g = clipped(g)
                _write(m, b1 * m + (1 - b1) * g)
                _write(v, b2 * v + (1 - b2) * g * g)
                del g
                u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
                p32 = p.float()
                u = u + cfg.weight_decay * p32
                _write(p, (p32 - lr * u).to(p.dtype))
        return params, state, {"gnorm": gnorm, "lr": lr}

    if cfg.name == "adafactor":
        d2 = 0.999  # v decay
        f_dicts = [_at(state["f"], path) for path, _ in flatten(params)]
        if cfg.stochastic_rounding and key is None:
            dev = _tensors(flat_p[0])[0].device
            # (The dry run's meta tensors draw nothing: no generator there.)
            key = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(0)
        for i, (pl, gl, f, spec) in enumerate(zip(flat_p, flat_g, f_dicts, specs)):
            g = _stacked(gl) * scale
            g2 = g * g + 1e-30
            spec = spec + (None,) * (g.dim() - len(spec)) if spec else (None,) * g.dim()
            if "vr" in f:
                vr = d2 * f["vr"] + (1 - d2) * _mean(g2, -1, spec[-1])
                vc = d2 * f["vc"] + (1 - d2) * _mean(g2, -2, spec[-2])
                del g2
                vr_mean = _mean(vr, -1, spec[-2], keepdim=True)
                denom = ((vr / torch.clamp_min(vr_mean, 1e-30))[..., None]
                         * vc[..., None, :])
                u = g / torch.sqrt(denom + 1e-30)
                del denom
                _write(f["vr"], vr)
                _write(f["vc"], vc)
            else:
                v = d2 * f["v"] + (1 - d2) * g2
                del g2
                u = g / torch.sqrt(v + 1e-30)
                _write(f["v"], v)
            del g
            # Update clipping (Adafactor RMS rule).
            rms = torch.sqrt(_mean_all(u * u, spec) + 1e-30)
            u = u / torch.clamp_min(rms, 1.0)
            p32 = _stacked(pl)
            u = u + cfg.weight_decay * p32
            p32 = p32 - lr * u
            del u
            dtype = _tensors(pl)[0].dtype
            if cfg.stochastic_rounding and dtype == torch.bfloat16:
                new = _stochastic_round_to(
                    p32, dtype, key[i] if isinstance(key, (list, tuple)) else key)
            else:
                new = p32.to(dtype)
            del p32
            if isinstance(pl, Stack):
                for j, p in enumerate(pl):
                    _write(p, new[j])
            else:
                _write(pl, new)
        return params, state, {"gnorm": gnorm, "lr": lr}

    if cfg.name == "sgdm":
        flat_m = [leaf for _, leaf in flatten(state["m"])]
        for pl, gl, ml in zip(flat_p, flat_g, flat_m):
            for p, g, m in zip(_tensors(pl), _tensors(gl), _tensors(ml)):
                _write(m, 0.9 * m + clipped(g))
                _write(p, (p.float() - lr * m).to(p.dtype))
        return params, state, {"gnorm": gnorm, "lr": lr}

    raise ValueError(cfg.name)


def _mean(x: torch.Tensor, dim: int, entry, keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dim)`` of the whole leaf: over a mesh axis that splits
    ``dim`` (the spec ``entry``), the shards' sums summed, then divided by
    the whole length."""
    axes = shard_rules.spec_axes((entry,))
    mesh = par.ctx().mesh
    if not axes or mesh is None:
        return x.mean(dim, keepdim=keepdim)
    total = coll.all_reduce_raw(x.sum(dim, keepdim=keepdim), mesh, axes)
    return total / (x.shape[dim] * mesh.axis_size(axes))


def _mean_all(x: torch.Tensor, spec) -> torch.Tensor:
    """The mean of every element of the whole leaf (its shards' sums summed
    over the axes of ``spec``)."""
    axes = shard_rules.spec_axes(spec)
    mesh = par.ctx().mesh
    if not axes or mesh is None:
        return torch.mean(x)
    return coll.all_reduce_raw(x.sum(), mesh, axes) / (x.numel() * mesh.axis_size(axes))


def _at(tree, path: tuple):
    """The node of ``tree`` (nested dicts and lists) at ``path``."""
    for key in path:
        tree = tree[key] if isinstance(tree, dict) else tree[int(key)]
    return tree
