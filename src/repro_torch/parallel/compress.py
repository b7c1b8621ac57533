"""Wire footprint of the buffers that cross between shards.

The port's copy of ``pytree_wire_bytes`` from the reference package's
``parallel/compress.py`` (the rest of that module, int8 gradient
compression, belongs to the LM stack and is not ported yet).
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


def pytree_wire_bytes(tree) -> int:
    """Static wire footprint of a nested tuple / list / dict of tensors or
    arrays in bytes: sum over leaves of element count × item size — what
    one lane puts on the wire when the tree crosses a collective."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:  # an array, or a scalar counted as float32 (as the reference does)
            shape = getattr(leaf, "shape", ())
            itemsize = np.dtype(getattr(leaf, "dtype", np.float32)).itemsize
            total += int(np.prod(shape, dtype=np.int64)) * itemsize
    return total
