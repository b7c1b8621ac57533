"""Wire footprint of the buffers that cross between shards, and int8
error-feedback gradient compression: the port of the reference package's
``parallel/compress.py``.

``pytree_wire_bytes`` and ``pytree_wire_bytes_int8`` meter DDC's phase-2
exchanges.  ``quantize_int8`` / ``dequantize_int8`` (one float32 absmax
scale a tensor), ``compress_decompress`` (the wire format's numerics
around each gradient leaf) and ``ef_compress`` (the error-feedback form,
carrying the quantisation residual into the next step) are the
reference's, bit for bit.  Without a mesh the train step applies none of
them, as the reference's does not.

Between the ranks of a ``launch.mesh.Mesh``: ``int8_all_to_all`` (the MoE
a2a dispatch's int8 wire, int8 rows and float32 row scales in both
directions, ``_quant_rows``' numerics) and ``shard_map_all_reduce`` (the
explicit int8 all-reduce over the DP axes: int32 sum of the int8 values,
max of the scales, then the mean), bit for bit the reference's.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.tree import Leaf, Stack
from repro_torch.parallel import collectives as coll


def _leaves(tree):
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _leaves(item)
    elif tree is not None:
        yield tree


def _leaf_info(leaf):
    """(shape, item size, is float) of a tensor, an array or a scalar (a
    scalar counts as float32, as the reference counts it)."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.element_size(), leaf.is_floating_point()
    dtype = np.dtype(getattr(leaf, "dtype", np.float32))
    return (tuple(getattr(leaf, "shape", ())), dtype.itemsize,
            bool(np.issubdtype(dtype, np.floating)))


def pytree_wire_bytes(tree) -> int:
    """Static wire footprint of a nested tuple / list / dict of tensors or
    arrays in bytes: sum over leaves of element count × item size — what
    one lane puts on the wire when the tree crosses a collective."""
    total = 0
    for leaf in _leaves(tree):
        shape, itemsize, _ = _leaf_info(leaf)
        total += int(np.prod(shape, dtype=np.int64)) * itemsize
    return total


def pytree_wire_bytes_int8(tree) -> int:
    """Prospective wire footprint if every float leaf shipped as int8 with
    one float32 absmax scale per leading-axis row: n + 4 × rows bytes for
    a float leaf of n elements, integer and bool leaves as they are.  The
    stream benchmark reports it beside a dirty ClusterSet's real bytes
    (``delta_bytes_int8``); nothing ships it."""
    total = 0
    for leaf in _leaves(tree):
        shape, itemsize, is_float = _leaf_info(leaf)
        n = int(np.prod(shape, dtype=np.int64))
        total += n + 4 * (shape[0] if shape else 1) if is_float else n * itemsize
    return total


def quantize_int8(x: torch.Tensor, absmax: torch.Tensor | None = None):
    """(q int8, scale float32 0-d): scale = (max|x| + 1e-12) / 127 and q =
    clip(round(x / scale), −127, 127), halves to even.  ``absmax``: max|x|
    when x is a shard of the leaf (the whole leaf's)."""
    absmax = (torch.max(torch.abs(x)) if absmax is None else absmax) + 1e-12
    # Tensor divisors: on the card a division by a Python scalar multiplies
    # by its reciprocal, which is not the reference's true division.
    scale = absmax / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_dequantize(g: torch.Tensor, absmax: torch.Tensor | None = None) -> torch.Tensor:
    """One leaf's wire-format round trip (``compress_decompress``'s),
    with the whole leaf's ``absmax`` when g is a shard of it."""
    q, s = quantize_int8(g.to(torch.float32), absmax)
    return dequantize_int8(q, s).to(g.dtype)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts / lists / tuples of tensors (a
    ``Stack``, the port's stacked leaf, is one leaf)."""
    if isinstance(tree, Leaf):
        return fn(tree, *rest)
    if isinstance(tree, Mapping):
        return {key: _tree_map(fn, tree[key], *(r[key] for r in rest)) for key in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, *subs) for subs in zip(tree, *rest))
    return fn(tree, *rest)


def compress_decompress(grads):
    """Quantise/dequantise each leaf (wire-format numerics); a ``Stack``
    whole, with its groups' absmax, as the reference's stacked leaf."""
    def one(g):
        if isinstance(g, Stack):
            absmax = torch.stack([t.float().abs().amax() for t in g]).amax()
            return Stack(quantize_dequantize(t, absmax) for t in g)
        return quantize_dequantize(g)
    return _tree_map(one, grads)


def ef_compress(grads, errors):
    """Error-feedback compression: returns (wire_grads, new_errors), both
    in ``grads``' structure; ``errors`` is the previous step's float32
    residual in the same structure."""
    residuals = []

    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, s = quantize_int8(g32)
        deq = dequantize_int8(q, s)
        residuals.append(g32 - deq)
        return deq.to(g.dtype)

    wire = _tree_map(one, grads, errors)
    it = iter(residuals)
    return wire, _tree_map(lambda _: next(it), grads)


_INV_127 = float(np.float32(1) / np.float32(127))


def _quant_rows(x: torch.Tensor):
    """(q int8, scale (..., 1) float32) a row (the last axis): scale =
    max(absmax · float32(1/127), 1e-12), q = clip(round(x / scale), −127,
    127), halves to even.  The reference writes absmax / 127, and XLA
    compiles that row-wise division by a constant into a multiply by its
    float32 reciprocal (in 5 % of rows it differs from the true quotient
    by an ulp): the port computes what the compiled reference does.  (B9's
    int8 mode divides truly, as the Pallas body does.)"""
    x32 = x.to(torch.float32)
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax * _INV_127, 1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def a2a_rows_int8(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``x`` (D·C, d) or (D, C, d) quantised by rows, the int8 rows and
    their scales exchanged by all-to-all over ``axis`` (block i to the
    i-th rank), and dequantised to x's dtype (no autograd)."""
    n = mesh.axis_size(axis)
    shape = x.shape
    q, scale = _quant_rows(x.reshape(n, -1, shape[-1]))
    q = coll.all_to_all_raw(q, mesh, axis)
    scale = coll.all_to_all_raw(scale, mesh, axis)
    return (q.to(torch.float32) * scale).to(x.dtype).reshape(shape)


class _Int8AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return a2a_rows_int8(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return a2a_rows_int8(g, *ctx.args), None, None


def int8_all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """all_to_all over the mesh ``axis`` with int8 wire format in BOTH
    directions (per-row absmax scales ride along in float32): the
    reference's custom-VJP ``int8_all_to_all``.  x: (D, C, d) -> (D, C,
    d); the backward quantises the incoming cotangent the same way and
    sends it back."""
    return _Int8AllToAll.apply(x, mesh, axis)


def shard_map_all_reduce(grads, mesh, axes=("pod", "data")):
    """Explicit int8 all-reduce over the DP axes: each leaf quantised
    (``quantize_int8``), its int8 values summed as int32 over ``axes``,
    the scales' max taken, then qsum · s / n (n the ranks summed) in the
    leaf's dtype.  Collective bytes drop 4x vs float32 (the int32 sum is
    the gloo/NCCL wire; the reference's psum moves int32 too)."""
    axes = tuple(a for a in axes if a in mesh.shape)
    if not axes:
        return grads
    n = mesh.axis_size(axes)

    def one(g):
        q, s = quantize_int8(g.to(torch.float32))
        qsum = coll.all_reduce_raw(q.to(torch.int32), mesh, axes)
        s = coll.all_reduce_raw(s, mesh, axes, op=dist.ReduceOp.MAX)
        out = qsum.to(torch.float32) * s
        return (out / torch.full_like(out, float(n))).to(g.dtype)

    return _tree_map(one, grads)
