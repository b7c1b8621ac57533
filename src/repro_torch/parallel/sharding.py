"""Parameter / cache / optimizer-state sharding rules: the port of the
reference package's ``parallel/sharding.py``.

Maps every parameter-tree leaf to a partition spec by its path:

  TP  ('model'):  attention projections, MLP in/out, expert dims (EP),
                  vocab (embed & head).
  FSDP ('data'):  with ``fsdp=True``, each leaf additionally shards its
                  largest still-unsharded divisible dim over 'data'
                  (ZeRO-3: params *and* optimizer state; the layers
                  all-gather a leaf just before use).

Divisibility-aware: a dim that doesn't divide the mesh axis stays
replicated (e.g. 40 heads on a 16-lane model axis).

The rules are pure functions of a leaf's path (a tuple of str, the
reference's ``_path_strs``) and shape, so they run on abstract meshes
(``launch.mesh.make_production_mesh`` with fewer ranks).  A spec is a
tuple with one entry a dimension: None, an axis name, or a tuple of axis
names (the reference's ``PartitionSpec`` entries; ``P()`` is ``()``).
``local_slice`` gives this rank's shard of a leaf under a spec (the
shard jax would place on this rank's device) and ``shard_leaf`` cuts it.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.models.tree import Leaf, flatten, unflatten_like
from repro_torch.parallel.api import ParallelCtx


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return mesh.shape.get(axis, 1)
    return int(np.prod([mesh.shape.get(a, 1) for a in axis]))


def _trailing_spec(path: tuple[str, ...], ndim_unstacked: int,
                   moe_impl: str = "epsum") -> tuple[Any, ...]:
    """TP spec over the leaf's *unstacked* trailing dims."""
    name = path[-1]
    in_ffn = "ffn" in path
    in_mixer = "mixer" in path or "cross" in path
    shared = "shared" in path

    if name in ("embed", "lm_head"):
        return ("model", None)
    if in_ffn and not shared:
        if name == "router":
            return (None, None)
        if ndim_unstacked == 3:           # MoE expert weights (E, d, f)
            if moe_impl == "a2a":
                # Fully sharded, never gathered: experts over 'data',
                # expert-FFN dim over 'model' — matches the a2a island.
                if name in ("w1", "w3"):
                    return ("data", None, "model")
                return ("data", "model", None)
            return ("model", None, None)  # expert parallel — matches island
        if name in ("w1", "w3"):
            return (None, "model")
        if name == "w2":
            return ("model", None)
    if in_ffn and shared:
        return (None, "model") if name in ("w1", "w3") else ("model", None)
    if in_mixer:
        if name in ("wq", "wk", "wv", "w_uq", "w_uk", "w_uv", "w_in"):
            return (None, "model")
        if name in ("wo", "w_out"):
            return ("model", None)
        # w_dq / w_dkv / conv / a_log / dt_bias / d_skip / norms
        return (None,) * ndim_unstacked
    return (None,) * ndim_unstacked


def spec_for(path: tuple[str, ...], shape: tuple[int, ...], pctx: ParallelCtx) -> tuple:
    mesh = pctx.mesh
    if mesh is None:
        return ()
    ndim = len(shape)
    # Leaves under "blocks"/"encoder" carry one stacked leading group dim.
    n_stack = 1 if ("blocks" in path or "encoder" in path) else 0
    trailing = _trailing_spec(path, ndim - n_stack, moe_impl=pctx.moe_impl)
    spec_full = [None] * (ndim - len(trailing)) + list(trailing)

    # Drop non-divisible 'model' entries.
    for i, ax in enumerate(spec_full):
        if ax is not None and shape[i] % _axis_size(mesh, ax) != 0:
            spec_full[i] = None

    # FSDP: shard the largest remaining dim over 'data' (and 'pod' if
    # present — fully sharded across all DP lanes).  Axes already used by
    # the TP spec (e.g. a2a expert weights on 'data') are excluded — a
    # spec may not repeat a mesh axis.
    if pctx.fsdp:
        used: set = set()
        for ax in spec_full:
            if ax is None:
                continue
            used.update((ax,) if isinstance(ax, str) else ax)
        dp_axes = tuple(a for a in ("pod", "data")
                        if a in mesh.shape and a not in used)
        dp = _axis_size(mesh, dp_axes)
        if dp > 1:
            cand = [
                (shape[i], i)
                for i in range(ndim)
                if spec_full[i] is None and shape[i] % dp == 0 and shape[i] >= dp
            ]
            if cand:
                _, i = max(cand)
                spec_full[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    return tuple(spec_full)


class Spec(Leaf):
    """A partition spec held as one leaf of a tree of specs."""


def param_shardings(params, pctx: ParallelCtx):
    """The spec of every leaf of ``params`` (a tree as ``models/tree.py``
    flattens it: the LM's ``tree()``, nested dicts, or leaves with a
    ``shape``), in ``params``' structure, each a ``Spec``."""
    flat = flatten(params)
    return unflatten_like(params, [Spec(spec_for(path, tuple(leaf.shape), pctx))
                                   for path, leaf in flat])


def cache_spec(path: tuple[str, ...], shape: tuple[int, ...], mesh) -> tuple:
    """The spec of one cache leaf: batch over the DP axes; head_dim (GQA),
    latent rank (MLA) or SSM heads over 'model' (DESIGN.md §5)."""
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    bspec = batch_axes if len(batch_axes) > 1 else (batch_axes[0] if batch_axes else None)
    name = path[-1]
    ndim = len(shape)
    if name in ("k", "v", "xk", "xv"):      # (g, B, kv, S, hd)
        spec: tuple[Any, ...] = (None, bspec, None, None, "model")
    elif name == "ckv":                      # (g, B, S, r)
        spec = (None, bspec, None, "model")
    elif name == "kr":                       # (g, B, S, rope)
        spec = (None, bspec, None, None)
    elif name == "ssm":                      # (g, B, h, st, hd)
        spec = (None, bspec, "model", None, None)
    elif name == "conv":                     # (g, B, K-1, C)
        spec = (None, bspec, None, "model")
    else:
        spec = (None, bspec) + (None,) * (ndim - 2)
    spec = list(spec[:ndim])
    for i, ax in enumerate(spec):
        if ax is not None and shape[i] % _axis_size(mesh, ax) != 0:
            spec[i] = None
    return tuple(spec)


def cache_shardings(cfg, cache, pctx: ParallelCtx):
    """The spec of every leaf of a cache (``transformer.init_cache``'s
    tree), in its structure."""
    flat = flatten(cache)
    return unflatten_like(cache, [Spec(cache_spec(path, tuple(leaf.shape), pctx.mesh))
                                  for path, leaf in flat])


# ---------------------------------------------------------------------------
# This rank's shard
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> tuple:
    """The mesh axes a spec shards over, in order of appearance."""
    return tuple(a for entry in spec for a in _entry_axes(entry))


def _entry_index(entry, mesh, coords=None) -> tuple[int, int]:
    """(shard count, this rank's shard) of one spec entry: the entry's
    axes taken row-major in the order listed, as jax numbers shards
    (``coords``: another mesh position's instead of this rank's)."""
    n, idx = 1, 0
    c = mesh.coords if coords is None else coords
    for a in _entry_axes(entry):
        if a not in mesh.shape:     # an axis the mesh lacks: one shard
            continue
        idx = idx * mesh.shape[a] + c[a]
        n *= mesh.shape[a]
    return n, idx


def local_slice(shape, spec, mesh, coords=None) -> tuple:
    """This rank's shard (the one at mesh position ``coords``) of a leaf of
    ``shape`` under ``spec``: one slice a dimension."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for d, entry in zip(shape, spec):
        n, i = _entry_index(entry, mesh, coords)
        if d % n:
            raise ValueError(f"dimension {d} does not split into {n} shards")
        out.append(slice(i * (d // n), (i + 1) * (d // n)))
    return tuple(out)


def shard_leaf(full, spec, mesh):
    """This rank's shard of the whole leaf ``full`` (a tensor or array), a
    copy of its own."""
    part = full[local_slice(tuple(full.shape), spec, mesh)]
    return part.clone() if hasattr(part, "clone") else np.array(part)



def unshard(t, spec, mesh):
    """The whole leaf from this rank's shard ``t`` under ``spec``: an
    all-gather over the axes of each sharded dimension (every rank must
    call; no autograd)."""
    from repro_torch.parallel import collectives as coll

    for dim, entry in enumerate(spec or ()):
        axes = tuple(a for a in _entry_axes(entry) if a in mesh.shape)
        if axes:
            t = coll.gather_raw(t, mesh, axes, dim)
    return t


def shard_module(module, path: tuple, pctx: ParallelCtx) -> None:
    """Cut each whole parameter of ``module`` (the module at ``path`` of
    the parameter tree, e.g. ("blocks", "l0", "ffn")) to this rank's shard
    under ``spec_for`` in place, and give it its spec (per group under
    "blocks" / "encoder", whose leaves stack a group axis)."""
    stacked = bool(path) and path[0] in ("blocks", "encoder")
    for name, p in module.named_parameters():
        shape = ((1,) if stacked else ()) + tuple(p.shape)
        spec = spec_for(tuple(path) + tuple(name.split(".")), shape, pctx)
        spec = spec[1:] if stacked else spec
        if any(e is not None for e in spec):
            p.data = shard_leaf(p.data, spec, pctx.mesh)
        p.spec = tuple(spec)
