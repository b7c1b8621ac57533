"""The training step: the port of the reference package's
``train/step.py``, on one card or over a mesh of ranks.

``build_train_step`` returns ``step_fn(state, batch) -> (state,
metrics)``: the loss and the parameters' gradients (``torch.autograd``,
summed over ``microbatches`` in float32 and scaled by 1/n as the
reference's scan does), then ``optimizer.apply_updates``.  The reference
jits the step with the state donated; the port runs eagerly and updates
the parameters and the optimizer state in place (see
``optimizer.apply_updates``), so the returned state holds the same
tensors with the step counter advanced.  ``compress_grads`` without a mesh
is a no-op, as in the reference.

Over a mesh (``pctx.mesh``; the state built with ``make_train_state(...,
pctx=)``, each leaf this rank's shard) every rank is given the global
batch and takes its part (``ParallelCtx.shard_batch``: split over the DP
axes, replicated when it does not divide).  Each rank seeds its backward
with loss / (ranks in the mesh): the collectives' backward passes are
exact transposes, so the gradient of a leaf is the sum of the ranks'
gradients over the axes that do not shard it (an FSDP leaf's sum over
``data`` already came from its all-gather's reduce-scatter).  With
``compress_grads`` the reduced gradients go through the reference's
``compress_decompress``, each leaf's absmax taken over the whole leaf (a
max over its shards).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.tree import Stack, flatten, unflatten_like
from repro_torch.parallel import api as par
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import compress
from repro_torch.parallel import sharding as shard_rules
from repro_torch.train import optimizer as opt_mod


class TrainState(NamedTuple):
    params: Any          # the model (transformer.LM), parameters trainable
    opt: Any             # optimizer.init_state's tree
    step: torch.Tensor   # () int32, on the parameters' device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt_mod.OptConfig = opt_mod.OptConfig()
    microbatches: int = 1
    param_dtype: str = "float32"
    seed: int = 0


def make_train_state(cfg: ModelConfig, tcfg: TrainConfig, gen=None, *,
                     device="cuda", pctx=None) -> TrainState:
    """Seeded parameters (``transformer.init_params`` from ``gen``, a
    ``torch.Generator`` or a seed; ``tcfg.seed`` by default) in
    ``tcfg.param_dtype`` on ``device``, trainable, with a fresh optimizer
    state and step 0; with ``pctx`` holding a mesh, this rank's shards."""
    dtype = getattr(torch, tcfg.param_dtype)
    model = T.init_params(cfg, tcfg.seed if gen is None else gen, device=device, dtype=dtype,
                          trainable=True, pctx=pctx)
    return state_for(model, tcfg)


def state_for(model, tcfg: TrainConfig) -> TrainState:
    """A fresh ``TrainState`` around ``model`` (made trainable)."""
    model.requires_grad_(True)
    return TrainState(model, opt_mod.init_state(tcfg.opt, model),
                      torch.zeros((), dtype=torch.int32, device=model.embed.device))


def _grad_tree(model, grads: list):
    """``grads`` (one a parameter, in the tree's flatten order of its
    tensors) in the model tree's layout."""
    it = iter(grads)
    out = [Stack(next(it) for _ in leaf) if isinstance(leaf, Stack) else next(it)
           for _, leaf in flatten(model)]
    return unflatten_like(model, out)


def _params(model) -> list:
    return [t for _, leaf in flatten(model)
            for t in (leaf if isinstance(leaf, Stack) else (leaf,))]


def _loss_and_grads(cfg, tcfg, model, batch, seed: float = 1.0):
    """(loss, gradients in the model tree's layout).  One microbatch: the
    gradients in the parameters' dtype; n > 1: the batch split into n
    along its first axis, losses and float32 gradients summed in order,
    then scaled by 1/n.  ``seed``: the backward's seed (the cotangent of
    each loss)."""
    params = _params(model)

    def grads_of(loss):
        if seed == 1.0:
            return torch.autograd.grad(loss, params)
        return torch.autograd.grad(loss, params, torch.full_like(loss, seed))

    if tcfg.microbatches <= 1:
        loss = T.loss_fn(cfg, model, batch)
        return loss.detach(), _grad_tree(model, list(grads_of(loss)))

    n = tcfg.microbatches
    micro = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:])) for k, v in batch.items()}
    loss_acc = torch.zeros((), dtype=torch.float32, device=params[0].device)
    g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
    for i in range(n):
        loss = T.loss_fn(cfg, model, {k: v[i] for k, v in micro.items()})
        for acc, g in zip(g_acc, grads_of(loss)):
            acc += g.float()
        loss_acc = loss_acc + loss.detach()
    inv = 1.0 / n
    return loss_acc * inv, _grad_tree(model, [g * inv for g in g_acc])


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig, pctx: par.ParallelCtx):
    """Returns ``step_fn(state, batch) -> (state, metrics)``; ``batch`` a dict
    of tensors on the parameters' device, metrics {"gnorm", "lr", "loss"}
    (float32 tensors).  The step runs under ``pctx`` (its ``remat``)."""

    mesh = pctx.mesh

    def step_fn(state: TrainState, batch):
        if mesh is None:
            with par.use(pctx):
                return _update(state, *_loss_and_grads(cfg, tcfg, state.params, batch))
        local, split = pctx.shard_batch(batch)
        with par.use(dataclasses.replace(pctx, batch_sharded=split)):
            loss, grads = _loss_and_grads(cfg, tcfg, state.params, local, 1.0 / mesh.size)
            specs = [opt_mod.leaf_spec(leaf) for _, leaf in flatten(state.params)]
            grads = _reduce_grads(grads, specs, mesh)
            if pctx.compress_grads:
                grads = _compress_whole(grads, specs, mesh)
            return _update(state, loss, grads)

    def _update(state, loss, grads):
        with par.use(pctx):
            _, new_opt, metrics = opt_mod.apply_updates(
                tcfg.opt, grads, state.opt, state.params, state.step)
            del grads
            metrics = dict(metrics, loss=loss)
            return TrainState(state.params, new_opt, state.step + 1), metrics

    return step_fn


def _map_leaves(fn, grads, specs):
    """``fn(tensor, spec)`` over each tensor of each leaf (a ``Stack``'s
    groups with its per-group spec), in the tree's structure."""
    flat = [leaf for _, leaf in flatten(grads)]
    out = []
    for leaf, spec in zip(flat, specs):
        if isinstance(leaf, Stack):
            out.append(Stack(fn(t, spec[1:] if spec else ()) for t in leaf))
        else:
            out.append(fn(leaf, spec))
    return unflatten_like(grads, out)


def _reduce_grads(grads, specs, mesh):
    """Each gradient summed over the mesh axes its spec does not shard it
    on (the ranks that hold the same shard)."""
    def one(g, spec):
        used = shard_rules.spec_axes(spec)
        return coll.all_reduce_raw(g, mesh, tuple(a for a in mesh.axis_names if a not in used))
    return _map_leaves(one, grads, specs)


def _compress_whole(grads, specs, mesh):
    """The reference's ``compress_decompress`` of each whole leaf: absmax
    over every shard (and group) of the leaf, then the int8 round trip
    (``mesh`` None: one process, every leaf whole)."""
    flat = [leaf for _, leaf in flatten(grads)]
    out = []
    for leaf, spec in zip(flat, specs):
        ts = tuple(leaf) if isinstance(leaf, Stack) else (leaf,)
        absmax = torch.stack([t.float().abs().amax() for t in ts]).amax()
        if mesh is not None:
            absmax = coll.all_reduce_raw(absmax, mesh, shard_rules.spec_axes(spec),
                                         op=dist.ReduceOp.MAX)
        new = [compress.quantize_dequantize(t, absmax) for t in ts]
        out.append(Stack(new) if isinstance(leaf, Stack) else new[0])
    return unflatten_like(grads, out)
