"""The training step: the port of the reference package's
``train/step.py`` for one card.

``build_train_step`` returns ``step_fn(state, batch) -> (state,
metrics)``: the loss and the parameters' gradients (``torch.autograd``,
summed over ``microbatches`` in float32 and scaled by 1/n as the
reference's scan does), then ``optimizer.apply_updates``.  The reference
jits the step with the state donated; the port runs eagerly and updates
the parameters and the optimizer state in place (see
``optimizer.apply_updates``), so the returned state holds the same
tensors with the step counter advanced.  ``compress_grads`` without a mesh
is a no-op, as in the reference (a mesh raises in ``ParallelCtx``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.tree import Stack, flatten, unflatten_like
from repro_torch.parallel import api as par
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
                     device="cuda") -> TrainState:
    """Seeded parameters (``transformer.init_params`` from ``gen``, a
    ``torch.Generator`` or a seed; ``tcfg.seed`` by default) in
    ``tcfg.param_dtype`` on ``device``, trainable, with a fresh optimizer
    state and step 0."""
    dtype = getattr(torch, tcfg.param_dtype)
    model = T.init_params(cfg, tcfg.seed if gen is None else gen, device=device, dtype=dtype,
                          trainable=True)
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


def _loss_and_grads(cfg, tcfg, model, batch):
    """(loss, gradients in the model tree's layout).  One microbatch: the
    gradients in the parameters' dtype; n > 1: the batch split into n
    along its first axis, losses and float32 gradients summed in order,
    then scaled by 1/n."""
    params = _params(model)
    if tcfg.microbatches <= 1:
        loss = T.loss_fn(cfg, model, batch)
        return loss.detach(), _grad_tree(model, list(torch.autograd.grad(loss, params)))

    n = tcfg.microbatches
    micro = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:])) for k, v in batch.items()}
    loss_acc = torch.zeros((), dtype=torch.float32, device=params[0].device)
    g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
    for i in range(n):
        loss = T.loss_fn(cfg, model, {k: v[i] for k, v in micro.items()})
        for acc, g in zip(g_acc, torch.autograd.grad(loss, params)):
            acc += g.float()
        loss_acc = loss_acc + loss.detach()
    inv = 1.0 / n
    return loss_acc * inv, _grad_tree(model, [g * inv for g in g_acc])


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig, pctx: par.ParallelCtx):
    """Returns ``step_fn(state, batch) -> (state, metrics)``; ``batch`` a dict
    of tensors on the parameters' device, metrics {"gnorm", "lr", "loss"}
    (float32 tensors).  The step runs under ``pctx`` (its ``remat``)."""

    def step_fn(state: TrainState, batch):
        with par.use(pctx):
            loss, grads = _loss_and_grads(cfg, tcfg, state.params, batch)
            # compress_grads needs a mesh, which ParallelCtx refuses on one card.
            _, new_opt, metrics = opt_mod.apply_updates(
                tcfg.opt, grads, state.opt, state.params, state.step)
            del grads
            metrics = dict(metrics, loss=loss)
            return TrainState(state.params, new_opt, state.step + 1), metrics

    return step_fn
