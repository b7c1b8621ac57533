"""Rank functions for tests/test_torch_mesh.py (the LM stack over gloo
ranks on the CPU).  The ranks import this module by name, so it imports
neither JAX nor the test module.  Each returns NumPy arrays and Python
values; the whole tensors are gathered on every rank and rank 0's are
compared."""
import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel import api as par
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import compress
from repro_torch.parallel import sharding as S
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import step as step_mod

MOE_ARCH = "llama4-scout-17b-a16e"
TRAIN_ARCH = "qwen3-8b"


def _mesh(group, dev, shape, axes):
    return mesh_mod.make_mesh(shape, axes, group, device=dev)


def mesh_facts(rank, group, dev, shape, axes):
    """This rank's coordinates, group ranks and backend."""
    mesh = _mesh(group, dev, shape, axes)
    return {"coords": mesh.coords, "backend": mesh.backend, "staged": mesh.staged,
            "groups": {a: torch.distributed.get_process_group_ranks(mesh.group(a))
                       for a in axes},
            "index_pod_data": mesh.index(("pod", "data"))}


def int8_a2a(rank, group, dev, x_all, dy_all):
    """``int8_all_to_all`` over 8 ``data`` lanes: rank r sends its block
    x_all[r] (D, C, d); returns (y, dx) of the cotangent dy_all[r], and
    the plain ``all_to_all``'s (y, dx)."""
    mesh = _mesh(group, dev, (len(x_all),), ("data",))
    out = []
    for fn in (lambda x: compress.int8_all_to_all(x, mesh, "data"),
               lambda x: coll.all_to_all(x, mesh, "data")):
        x = torch.tensor(x_all[rank], requires_grad=True)
        y = fn(x)
        (dx,) = torch.autograd.grad(y, x, torch.tensor(dy_all[rank]))
        out.append((y.detach().numpy(), dx.numpy()))
    return out


def int8_allreduce(rank, group, dev, same, each):
    """``shard_map_all_reduce`` over 8 ``data`` lanes of the same leaf
    ``same`` on every rank, and of ``each[rank]``."""
    mesh = _mesh(group, dev, (len(each),), ("data",))
    a = compress.shard_map_all_reduce({"w": torch.tensor(same)}, mesh, axes=("data",))
    b = compress.shard_map_all_reduce({"w": torch.tensor(each[rank])}, mesh, axes=("data",))
    return a["w"].numpy(), b["w"].numpy()


def collectives_grad(rank, group, dev, x_all):
    """all_gather / reduce_scatter / all_reduce over the ``model`` axis of a
    (2, 4) mesh with their gradients: each rank's (forward, backward) of a
    sum weighted by its rank."""
    mesh = _mesh(group, dev, (2, 4), ("data", "model"))
    x = torch.tensor(x_all[rank], requires_grad=True)
    w = float(rank + 1)
    out = {}
    for name, fn in (("all_gather", lambda t: coll.all_gather(t, mesh, "model", 1)),
                     ("reduce_scatter", lambda t: coll.reduce_scatter(t, mesh, "model", 1)),
                     ("all_reduce", lambda t: coll.all_reduce(t, mesh, "model"))):
        y = fn(x)
        (dx,) = torch.autograd.grad((y * w).sum(), x)
        out[name] = (y.detach().numpy(), dx.numpy())
    return out


def _moe_module(cfg, p_np, pctx, dev):
    moe = L.MoE(cfg, None, device=dev)
    for name, t in moe.named_parameters():
        t.data = torch.tensor(p_np[name])
    S.shard_module(moe, ("blocks", "l0", "ffn"), pctx)
    return moe


def moe_rank(rank, group, dev, shape, axes, impl, int8, p_np, x_np, w_np, cf=None):
    """``moe_apply`` of tiny llama4-scout on a mesh (at capacity factor
    ``cf``, or the tiny config's): (y whole, aux, dx whole, {param: grad
    whole}) of the loss Σ y·w, the batch split over the DP axes when it
    divides."""
    mesh = _mesh(group, dev, shape, axes)
    cfg = configs.get_config(MOE_ARCH).tiny()
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    pctx = par.ParallelCtx(mesh=mesh, moe_impl=impl, a2a_int8=int8)
    moe = _moe_module(cfg, p_np, pctx, dev).requires_grad_(True)
    local, split = pctx.shard_batch({"x": torch.tensor(x_np), "w": torch.tensor(w_np)})
    x = local["x"].clone().requires_grad_(True)
    with par.use(dataclasses.replace(pctx, batch_sharded=split)):
        route = L.moe_route(cfg)
        y, aux = L.moe_apply(cfg, moe, x)
        # Σ y·w over the global batch: the ranks of a DP lane's model
        # column hold the same rows, so each seeds 1/m (1/world when the
        # batch is replicated on every lane).
        seed = 1.0 / (mesh.shape.get("model", 1) * (1 if split else pctx.dp))
        loss = (y * local["w"]).sum() * seed + aux * seed / (pctx.dp if split else 1)
        params = list(moe.parameters())
        grads = torch.autograd.grad(loss, [x] + params)
    dx = coll.all_reduce_raw(grads[0], mesh, "model")
    if not split:
        dx = coll.all_reduce_raw(dx, mesh, pctx.dp_axes)
    y_all = coll.gather_raw(y.detach(), mesh, pctx.dp_axes, 0) if split else y.detach()
    dx_all = coll.gather_raw(dx, mesh, pctx.dp_axes, 0) if split else dx
    dp = {}
    for (name, p), g in zip(moe.named_parameters(), grads[1:]):
        used = S.spec_axes(p.spec)
        g = coll.all_reduce_raw(g, mesh, tuple(a for a in axes if a not in used))
        dp[name] = S.unshard(g, p.spec, mesh).numpy()
    return (route, y_all.numpy(), float(aux.detach()), dx_all.numpy(), dp)


def moe_one_rank(p_np, x_np, w_np, routes=None):
    """The port's one-rank ``moe_apply`` (the "local" route, at the tiny
    config's drop-free capacity) with the same loss's gradients, run
    inside the context manager ``routes`` if given (one that makes the
    route drop what a mesh route drops): (y, aux, dx, {param: grad})."""
    cfg = configs.get_config(MOE_ARCH).tiny()
    moe = L.MoE(cfg, None, device="cpu")
    for name, t in moe.named_parameters():
        t.data = torch.tensor(p_np[name])
    moe.requires_grad_(True)
    x = torch.tensor(x_np, requires_grad=True)
    with routes if routes is not None else contextlib.nullcontext():
        y, aux = L.moe_apply(cfg, moe, x)
    grads = torch.autograd.grad((y * torch.tensor(w_np)).sum() + aux, [x] + list(moe.parameters()))
    return (y.detach().numpy(), float(aux.detach()), grads[0].numpy(),
            {name: g.numpy() for (name, _), g in zip(moe.named_parameters(), grads[1:])})


def _whole_params(model, mesh):
    return {name: S.unshard(p.detach(), getattr(p, "spec", ()), mesh).numpy()
            for name, p in model.named_parameters()}


def train_rank(rank, group, dev, shape, axes, pctx_kw, opt_kw, batch, steps, ckpt=None):
    """``steps`` train steps of tiny qwen3-8b on a mesh, parameters from
    seed 0: (losses, gnorms, whole parameters after); with ``ckpt`` the
    state is saved there after the steps."""
    mesh = _mesh(group, dev, shape, axes)
    cfg = configs.get_config(TRAIN_ARCH).tiny()
    pctx = par.ParallelCtx(mesh=mesh, **pctx_kw)
    tcfg = step_mod.TrainConfig(opt=opt_mod.OptConfig(**opt_kw))
    state = step_mod.make_train_state(cfg, tcfg, gen=0, device=dev, pctx=pctx)
    step_fn = step_mod.build_train_step(cfg, tcfg, pctx)
    batch = {k: torch.tensor(v) for k, v in batch.items()}
    losses, gnorms = [], []
    for _ in range(steps):
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["gnorm"]))
    if ckpt is not None:
        with par.use(pctx):
            ck.save(ckpt, state, steps)
    return losses, gnorms, _whole_params(state.params, mesh)


def restore_rank(rank, group, dev, shape, axes, pctx_kw, opt_kw, ckpt):
    """The train state of ``train_rank`` restored from ``ckpt`` onto
    another mesh: (whole parameters, whole AdamW moments, step, this
    rank's wq shard spec)."""
    mesh = _mesh(group, dev, shape, axes)
    cfg = configs.get_config(TRAIN_ARCH).tiny()
    pctx = par.ParallelCtx(mesh=mesh, **pctx_kw)
    tcfg = step_mod.TrainConfig(opt=opt_mod.OptConfig(**opt_kw))
    like = step_mod.make_train_state(cfg, tcfg, gen=1, device=dev, pctx=pctx)
    with par.use(pctx):
        state, manifest = ck.restore(ckpt, like)
    moments = {}
    for path, leaf in ck.flatten(state.opt):
        for i, t in enumerate(leaf if isinstance(leaf, ck.Stack) else (leaf,)):
            moments[("/".join(path), i)] = S.unshard(t, getattr(t, "spec", ()), mesh).numpy()
    wq = state.params.blocks[0]["l0"].mixer.wq
    return _whole_params(state.params, mesh), moments, int(state.step), wq.spec


def elastic_rank(rank, group, dev, ckpt):
    """The reference's elastic check: an (8, 8) leaf saved from 8 ``data``
    lanes (spec ("data", None)), restored onto (data 4, model 2) with
    spec ("model", "data"); returns (this rank's restored shard, its
    slice, the whole leaf gathered back)."""
    mesh8 = _mesh(group, dev, (8,), ("data",))
    x = torch.arange(64.0).reshape(8, 8)
    xs = S.shard_leaf(x, ("data", None), mesh8)
    xs.spec = ("data", None)
    ck.save(ckpt, {"x": xs}, 1, mesh=mesh8)
    mesh42 = _mesh(group, dev, (4, 2), ("data", "model"))
    restored, _ = ck.restore(ckpt, {"x": torch.empty(8, 8)},
                             shardings={"x": ("model", "data")}, mesh=mesh42)
    r = restored["x"]
    sl = S.local_slice((8, 8), ("model", "data"), mesh42)
    return (r.numpy(), [(s.start, s.stop) for s in sl], r.spec,
            S.unshard(r, r.spec, mesh42).numpy())


def serve_tp_rank(rank, group, dev, arch, prompts, steps):
    """Greedy generation of a tiny model sharded over (data 4, model 2):
    head-parallel attention with each rank's kv heads in its cache, the
    MLP over ``ff``, the vocab-parallel embedding and head; each rank
    generates for its prompt (the batch split over ``data``).  Returns
    (every prompt's tokens, the prefill's logits), gathered."""
    from repro_torch.serve import engine

    mesh = _mesh(group, dev, (4, 2), ("data", "model"))
    cfg = configs.get_config(arch).tiny()
    pctx = par.ParallelCtx(mesh=mesh)
    model = T.init_params(cfg, 0, device=dev, pctx=pctx)
    local, split = pctx.shard_batch({"p": torch.tensor(prompts)})
    scfg = engine.ServeConfig(max_len=prompts.shape[1] + steps)
    trace: dict = {}
    with par.use(dataclasses.replace(pctx, batch_sharded=split)):
        out = engine.greedy_generate(cfg, model, local["p"], steps, scfg, trace=trace)
        kv = T.init_cache(cfg, 1, 4, device=dev)["l0"]["k"].shape
    toks = coll.gather_raw(out, mesh, pctx.dp_axes, 0)
    logits = coll.gather_raw(trace["logits"][0], mesh, pctx.dp_axes, 0)
    return toks.numpy(), logits.numpy(), tuple(kv)


def serve_one_rank(arch, prompts, steps):
    from repro_torch.serve import engine

    cfg = configs.get_config(arch).tiny()
    model = T.init_params(cfg, 0, device="cpu")
    trace: dict = {}
    out = engine.greedy_generate(cfg, model, torch.tensor(prompts), steps,
                                 engine.ServeConfig(max_len=prompts.shape[1] + steps), trace=trace)
    return out.numpy(), trace["logits"][0].numpy()


def tp_cfg(arch, overrides):
    """Tiny ``arch`` with ``overrides`` (``ModelConfig.tiny``'s)."""
    return configs.get_config(arch).tiny(**(overrides or {}))


def tp_train_rank(rank, group, dev, shape, axes, arch, overrides, tree, batch, steps, opt_kw):
    """``steps`` train steps (FSDP) of tiny ``arch`` on a mesh, its
    parameters the reference's ``tree`` carried in by ``params_from_jax(...,
    pctx=)``: (losses, gnorms, whole parameters after)."""
    mesh = _mesh(group, dev, shape, axes)
    cfg = tp_cfg(arch, overrides)
    pctx = par.ParallelCtx(mesh=mesh, fsdp=True)
    tcfg = step_mod.TrainConfig(opt=opt_mod.OptConfig(**opt_kw))
    state = step_mod.state_for(T.params_from_jax(cfg, tree, device=dev, pctx=pctx), tcfg)
    step_fn = step_mod.build_train_step(cfg, tcfg, pctx)
    batch = {k: torch.tensor(v) for k, v in batch.items()}
    losses, gnorms = [], []
    for _ in range(steps):
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["gnorm"]))
    return losses, gnorms, _whole_params(state.params, mesh)


def _generate(cfg, model, prompts, steps, frames):
    """Greedy tokens, every step's logits and the prefill cache's first
    layer (group 0) of ``prompts`` under the current context."""
    from repro_torch.serve import engine

    p = torch.tensor(prompts)
    f = None if frames is None else torch.tensor(frames)
    trace: dict = {}
    out = engine.greedy_generate(cfg, model, p, steps,
                                 engine.ServeConfig(max_len=p.shape[1] + steps),
                                 frames=f, trace=trace)
    _, cache, _ = T.prefill(cfg, model, p, frames=f)
    return (out.numpy(), [t.numpy() for t in trace["logits"]],
            {k: v[0].numpy() for k, v in cache["l0"].items()})


def tp_serve_rank(rank, group, dev, shape, axes, arch, overrides, tree, prompts, steps,
                  frames=None):
    """Greedy generation of tiny ``arch`` with the reference's ``tree``
    sharded over the mesh (every rank the whole batch): ``_generate``'s
    tokens, logits and this rank's cache, its ``model`` lane, and the
    last-axis strides of every B7 / B8 input (the card's kernels need
    1)."""
    from repro_torch.kernels import ops

    mesh = _mesh(group, dev, shape, axes)
    cfg = tp_cfg(arch, overrides)
    pctx = par.ParallelCtx(mesh=mesh, batch_sharded=False)
    model = T.params_from_jax(cfg, tree, device=dev, pctx=pctx)
    strides = set()
    real = ops.flash_attention, ops.ssd_scan

    def last_strides(fn):
        def run(*ts, **kw):
            strides.update(t.stride(-1) for t in ts)
            return fn(*ts, **kw)
        return run

    ops.flash_attention, ops.ssd_scan = map(last_strides, real)
    try:
        with par.use(pctx):
            out = _generate(cfg, model, prompts, steps, frames)
    finally:
        ops.flash_attention, ops.ssd_scan = real
    return out + (mesh.coords["model"], strides)


def tp_serve_one_rank(arch, overrides, tree, prompts, steps, frames=None):
    cfg = tp_cfg(arch, overrides)
    return _generate(cfg, T.params_from_jax(cfg, tree, device="cpu"), prompts, steps, frames)


def dryrun_step_rank(rank, group, dev, shape, axes, arch, tokens_shape):
    """One train step of tiny ``arch`` as the LM dry run lowers it
    (``launch/dryrun.py``'s ``train_recipe``, FSDP, remat "full") on a
    mesh, from seed 0 on zero tokens: this rank's ``collectives.STATS``
    over the step."""
    import copy

    from repro_torch.launch import dryrun as dr

    mesh = _mesh(group, dev, shape, axes)
    cfg = configs.get_config(arch).tiny()
    pctx = par.ParallelCtx(mesh=mesh, fsdp=True, remat="full")
    tcfg = dr.train_recipe(arch)
    state = step_mod.make_train_state(cfg, tcfg, gen=0, device=dev, pctx=pctx)
    batch = {"tokens": torch.zeros(tokens_shape, dtype=torch.int32)}
    coll.reset_stats()
    step_mod.build_train_step(cfg, tcfg, pctx)(state, batch)
    return copy.deepcopy(coll.STATS)
