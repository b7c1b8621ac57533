"""Wire footprint of the buffers that cross between shards, and int8
error-feedback gradient compression: the port of the reference package's
``parallel/compress.py``.

``pytree_wire_bytes`` and ``pytree_wire_bytes_int8`` meter DDC's phase-2
exchanges.  ``quantize_int8`` / ``dequantize_int8`` (one float32 absmax
scale a tensor), ``compress_decompress`` (the wire format's numerics
around each gradient leaf) and ``ef_compress`` (the error-feedback form,
carrying the quantisation residual into the next step) are the
reference's, bit for bit.  Without a mesh the train step applies none of
them, as the reference's does not.  ``int8_all_to_all`` (the MoE
dispatch's int8 wire) and ``shard_map_all_reduce`` (the explicit int8
all-reduce) move data between cards and wait for ROADMAP A10 item 6.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


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


def quantize_int8(x: torch.Tensor):
    """(q int8, scale float32 0-d): scale = (max|x| + 1e-12) / 127 and q =
    clip(round(x / scale), −127, 127), halves to even."""
    absmax = torch.max(torch.abs(x)) + 1e-12
    # Tensor divisors: on the card a division by a Python scalar multiplies
    # by its reciprocal, which is not the reference's true division.
    scale = absmax / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts / lists / tuples of tensors."""
    if isinstance(tree, Mapping):
        return {key: _tree_map(fn, tree[key], *(r[key] for r in rest)) for key in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, *subs) for subs in zip(tree, *rest))
    return fn(tree, *rest)


def compress_decompress(grads):
    """Quantise/dequantise each leaf (wire-format numerics)."""
    def one(g):
        q, s = quantize_int8(g.to(torch.float32))
        return dequantize_int8(q, s).to(g.dtype)
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
