"""Parallelism context threaded through the model stack: the port of the
reference package's ``parallel/api.py`` for one card.

The context carries the reference's fields.  On one card the port reads
``remat`` (``models/transformer.py`` checkpoints each block group: "full"
recomputes it whole in the backward pass, "dots" keeps the products of
matrices without a batch axis and recomputes the rest), and the MoE
layer keeps the reference's one-device route, which is its ``moe_impl``
"local" behaviour whatever the field says.  ``constrain`` is the identity:
there is no mesh to lay an activation on.

A mesh, ``fsdp=True``, or ``compress_grads=True`` with a mesh needs
several cards: those paths (the reference's sharding rules, FSDP, the
int8 gradient all-reduce) are not ported yet, and ``ParallelCtx`` raises
``ValueError`` naming ROADMAP A10 item 6.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Mapping

DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": "model",      # sequence-parallel alternative for long context
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "experts": "model",
    "vocab": "model",
    "embed": None,
    "state": None,
}

REMAT_MODES = ("none", "full", "dots")
_MULTI_CARD = "needs several cards, which the port does not drive yet (ROADMAP A10 item 6)"


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    mesh: Any = None
    rules: Mapping[str, Any] = dataclasses.field(default_factory=lambda: DEFAULT_RULES)
    fsdp: bool = False            # ZeRO-3: shard params/opt-state over 'data'
    seq_parallel: bool = False    # shard long sequences over 'model'
    moe_impl: str = "epsum"       # "epsum" | "a2a" | "local"; one card runs "local"
    a2a_int8: bool = False        # int8 wire format for the MoE dispatch
    remat: str = "none"           # "none" | "full" | "dots"
    compress_grads: bool = False  # int8 error-feedback all-reduce

    def __post_init__(self):
        if self.mesh is not None:
            raise ValueError(f"ParallelCtx(mesh=...) {_MULTI_CARD}")
        if self.fsdp:
            raise ValueError(f"ParallelCtx(fsdp=True) {_MULTI_CARD}")
        if self.remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got {self.remat!r}")


_STATE = threading.local()


def ctx() -> ParallelCtx:
    return getattr(_STATE, "ctx", None) or ParallelCtx()


@contextlib.contextmanager
def use(pctx: ParallelCtx):
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = pctx
    try:
        yield pctx
    finally:
        _STATE.ctx = prev


def constrain(x, *logical: Any):
    """The reference's sharding constraint; without a mesh (always, on one
    card) it returns ``x`` as it is."""
    return x
