"""Collectives over the axes of a ``launch.mesh.Mesh``, differentiable.

The port runs the reference's GSPMD shardings and ``shard_map`` islands
as explicit SPMD, one rank a mesh position.  These are the moves between
ranks, each a ``torch.autograd.Function`` whose backward is the exact
transpose of its forward:

* ``all_gather(x, mesh, axes, dim)`` — the shards of the ranks along
  ``axes`` concatenated on ``dim`` in mesh order; backward reduce-scatter
  (sum);
* ``reduce_scatter(x, mesh, axes, dim)`` — the sum over those ranks, split
  on ``dim``, this rank's part; backward all-gather;
* ``all_reduce(x, mesh, axes)`` — the sum over those ranks (the ``psum``
  of the reference's islands); backward the same sum of the cotangents;
* ``all_to_all(x, mesh, axis)`` — part i of x's leading axis to the i-th
  rank along ``axis``, part i of the result from it; backward the same
  exchange of the cotangents.

With exact transposes the gradient a rank computes is its share of the
total: each rank seeds its backward with loss / (ranks in the mesh), and a
leaf's gradient is the sum over the ranks that hold the same shard
(``train/step.py`` sums over the axes that do not shard it).  This holds
whatever the layer does with a replicated leaf (a norm inside the
head-parallel region, the MoE router inside an expert lane), which
Megatron's f/g pair (identity / all-reduce) would leave partial.

``all_reduce_max`` (no gradient) and the raw functions (``gather_raw``
and friends, no autograd) serve the optimizer, the checkpoint and the
int8 wire.  Every function works on NCCL, and on gloo, where a tensor on
a card is staged through pinned host memory (gloo's all-to-all takes CPU
tensors only), and in a fake world (``launch.mesh.fake_world``: the
dry run's one process standing for rank 0, where nothing moves and
nothing is staged).  ``STATS`` counts the collectives a rank made, the
bytes it put in, and the bytes it staged between the card and the host;
``STATS["kinds"]`` splits the calls and the bytes put in by kind
(``KINDS``), as the reference's ``launch/hlo_cost.py`` splits
``collective_counts`` / ``collectives`` (which count the result's bytes:
an all-gather's result is n times what a rank puts in, a
reduce-scatter's 1/n).  An axis of size 1 makes no call.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")
STATS = {"collectives": 0, "bytes": 0, "staged_bytes": 0,
         "kinds": {k: {"calls": 0, "bytes": 0} for k in KINDS}}

_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


def reset_stats() -> None:
    for k in ("collectives", "bytes", "staged_bytes"):
        STATS[k] = 0
    for kind in STATS["kinds"].values():
        kind.update(calls=0, bytes=0)


def _to_wire(t: torch.Tensor, mesh, kind: str) -> torch.Tensor:
    """The tensor the backend moves for a collective of ``kind``: a pinned
    host copy of a card tensor on gloo, else ``t`` itself (contiguous)."""
    t = t.contiguous()
    nbytes = t.numel() * t.element_size()
    STATS["collectives"] += 1
    STATS["bytes"] += nbytes
    STATS["kinds"][kind]["calls"] += 1
    STATS["kinds"][kind]["bytes"] += nbytes
    if t.is_cuda and mesh.staged:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        STATS["staged_bytes"] += nbytes
        return h
    return t


def _empty_wire(shape, like: torch.Tensor, wire: torch.Tensor) -> torch.Tensor:
    if wire.device != like.device:
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _from_wire(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if h.device != like.device:
        STATS["staged_bytes"] += h.numel() * h.element_size()
        return h.to(like.device)
    return h


def gather_raw(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """All-gather along ``dim`` over ``axes`` (no autograd)."""
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    dim = dim % x.dim()
    xt = x.movedim(dim, 0)
    w = _to_wire(xt, mesh, "all-gather")
    out = _empty_wire((n * w.shape[0],) + tuple(w.shape[1:]), x, w)
    _all_gather_single(out, w, group=mesh.group(axes))
    return _from_wire(out, x).movedim(0, dim)


def reduce_scatter_raw(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """Sum over ``axes``, this rank's part along ``dim`` (no autograd)."""
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    dim = dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dimension {x.shape[dim]} does not split "
                         f"into {n} parts")
    xt = x.movedim(dim, 0)
    w = _to_wire(xt, mesh, "reduce-scatter")
    out = _empty_wire((w.shape[0] // n,) + tuple(w.shape[1:]), x, w)
    _reduce_scatter_single(out, w, group=mesh.group(axes))
    return _from_wire(out, x).movedim(0, dim)


def all_reduce_raw(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction (sum by default) over ``axes`` (no autograd); a new
    tensor."""
    if mesh.axis_size(axes) == 1:
        return x.clone()
    w = _to_wire(x, mesh, "all-reduce")
    if w is x:
        w = x.clone()
    dist.all_reduce(w, op=op, group=mesh.group(axes))
    return _from_wire(w, x)


def all_to_all_raw(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Part i of x's leading axis to the i-th rank along ``axis`` (no
    autograd)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: leading axis {x.shape[0]} does not split into {n}")
    w = _to_wire(x, mesh, "all-to-all")
    out = _empty_wire(tuple(w.shape), x, w)
    dist.all_to_all_single(out, w, group=mesh.group(axis))
    return _from_wire(out, x)


def all_reduce_max(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    return all_reduce_raw(x.detach(), mesh, axes, op=dist.ReduceOp.MAX)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return gather_raw(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_raw(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return reduce_scatter_raw(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_raw(g, *ctx.args), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return all_reduce_raw(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_raw(g, *ctx.args), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return all_to_all_raw(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_raw(g, *ctx.args), None, None


def all_gather(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    if mesh.axis_size(axes) == 1:
        return x
    return _AllGather.apply(x, mesh, axes, dim)


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    if mesh.axis_size(axes) == 1:
        return x
    return _ReduceScatter.apply(x, mesh, axes, dim)


def all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    if mesh.axis_size(axes) == 1:
        return x
    return _AllReduce.apply(x, mesh, axes)


def all_to_all(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    if mesh.axis_size(axis) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis)
