"""Wire footprint of the buffers that cross between shards.

The port's copies of ``pytree_wire_bytes`` and ``pytree_wire_bytes_int8``
from the reference package's ``parallel/compress.py`` (the rest of that
module, int8 gradient compression, belongs to the LM stack and is not
ported yet).
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
