"""Trees of tensors laid out as the reference package's pytrees.

The reference's model keeps every block parameter stacked over the block
groups (and every encoder parameter over the encoder layers) in one array;
the port keeps one tensor a group (``transformer.LM``).  A ``Stack`` is the
port's view of such a stacked leaf: the tuple of its per-group tensors, in
group order, counted as ONE leaf.  The optimizer reads a stacked leaf whole
where the reference's update is not elementwise (Adafactor's factored
moments and RMS clip), and the checkpoint writes it as one stacked array,
so both see the reference's leaves.

``flatten`` orders leaves as ``jax.tree_util`` does: a dict by its sorted
keys, a list or tuple by index, a NamedTuple by its fields in declaration
order; ``None`` is an empty subtree; a ``Leaf`` (a ``Stack``, a
partition spec) is one leaf.  An object with a ``tree()`` method
(the LM) flattens as the tree it returns.  Paths are tuples of str.
"""
from __future__ import annotations

from typing import Any, Callable


class Leaf(tuple):
    """A tuple that trees hold as one leaf (not a node)."""


class Stack(Leaf):
    """One stacked leaf of the reference: its per-group tensors, in order.
    ``shape`` is the stacked shape (groups first)."""

    @property
    def shape(self) -> tuple:
        return (len(self),) + tuple(self[0].shape)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] in the reference's leaf order; a ``Stack`` is a leaf."""
    if tree is None:
        return []
    if hasattr(tree, "tree") and callable(tree.tree):
        return flatten(tree.tree(), prefix)
    if isinstance(tree, Leaf):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [item for key in sorted(tree) for item in flatten(tree[key], prefix + (str(key),))]
    if _is_namedtuple(tree):
        return [item for name in tree._fields
                for item in flatten(getattr(tree, name), prefix + (name,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, sub in enumerate(tree) for item in flatten(sub, prefix + (str(i),))]
    return [(prefix, tree)]


def unflatten_like(tree, new_leaves: list):
    """``tree``'s structure (dicts, lists, tuples, NamedTuples; an object
    with ``tree()`` becomes that tree) holding ``new_leaves`` in flatten
    order."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if hasattr(node, "tree") and callable(node.tree):
            return build(node.tree())
        if isinstance(node, Leaf):
            return next(it)
        if isinstance(node, dict):
            out = {key: build(node[key]) for key in sorted(node)}
            return {key: out[key] for key in node}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, n)) for n in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub) for sub in node)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of ``tree``, in ``tree``'s structure."""
    return unflatten_like(tree, [fn(leaf) for _, leaf in flatten(tree)])
