"""Parallelism context threaded through the model stack: the port of the
reference package's ``parallel/api.py``.

The context carries the reference's fields and rules.  Its ``mesh`` is a
``launch.mesh.Mesh`` of rank processes (or None: one process).  The
reference's GSPMD shardings become explicit SPMD in the port: each rank
holds its shard of each parameter (``parallel/sharding.py``), and the
layers move data between ranks with the collectives of
``parallel/collectives.py``.  So ``constrain`` stays the identity: an
activation is already laid out by the code that made it.

``remat`` is read by ``models/transformer.py`` (it checkpoints each
block group: "full" recomputes it whole in the backward pass, "dots"
keeps the products of matrices without a batch axis and recomputes the
rest); ``moe_impl`` and ``a2a_int8`` by the MoE layer; ``fsdp`` by the
sharding rules; ``compress_grads`` by the train step.

``batch_sharded`` is the port's own field: whether the batch the ranks
hold is split over the DP axes (``pod``, ``data``) or replicated on each
of them, which the reference's ``constrain`` decides from the global
batch size (a batch that does not divide the DP lanes is replicated).
``shard_batch`` splits a global batch and says which it did.
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
DP_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    mesh: Any = None
    rules: Mapping[str, Any] = dataclasses.field(default_factory=lambda: DEFAULT_RULES)
    fsdp: bool = False            # ZeRO-3: shard params/opt-state over 'data'
    seq_parallel: bool = False    # shard long sequences over 'model'
    moe_impl: str = "epsum"       # "epsum" | "a2a" | "local"
    a2a_int8: bool = False        # int8 wire format for the MoE dispatch
    remat: str = "none"           # "none" | "full" | "dots"
    compress_grads: bool = False  # int8 error-feedback all-reduce
    batch_sharded: bool = True    # the ranks' batch is split over the DP axes

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got {self.remat!r}")

    def axis_size(self, logical: str) -> int:
        if self.mesh is None:
            return 1
        axes = self.rules.get(logical)
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        size = 1
        for a in axes:
            if a in self.mesh.shape:
                size *= self.mesh.shape[a]
        return size

    def spec(self, *logical: Any) -> tuple:
        """Map logical axes (or None) to a partition spec (a tuple, one entry
        a dimension: None, an axis name or a tuple of names) under the
        rules, dropping mesh axes that don't exist in the current mesh."""
        parts = []
        for l in logical:
            if l is None:
                parts.append(None)
                continue
            axes = self.rules.get(l, None) if isinstance(l, str) else l
            if axes is None:
                parts.append(None)
            elif isinstance(axes, str):
                parts.append(axes if self._has(axes) else None)
            else:
                kept = tuple(a for a in axes if self._has(a))
                parts.append(kept if kept else None)
        return tuple(parts)

    def _has(self, axis: str) -> bool:
        return self.mesh is not None and axis in self.mesh.shape

    @property
    def dp_axes(self) -> tuple:
        """The mesh's data-parallel axes (``pod``, ``data``) present."""
        return tuple(a for a in DP_AXES if self._has(a))

    @property
    def dp(self) -> int:
        """Data-parallel lanes: the product of the DP axes' sizes."""
        return self.mesh.axis_size(self.dp_axes) if self.mesh is not None else 1

    def shard_batch(self, batch: dict) -> tuple[dict, bool]:
        """(this rank's part of ``batch``, split?): each leaf's leading
        axis split into ``dp`` equal parts over the DP axes when every
        leaf's divides, else the whole batch (replicated on every lane)."""
        dp = self.dp
        if dp <= 1:
            return batch, True
        if any(v.shape[0] % dp for v in batch.values()):
            return batch, False
        i = self.mesh.index(self.dp_axes)
        return {k: v[i * (v.shape[0] // dp):(i + 1) * (v.shape[0] // dp)]
                for k, v in batch.items()}, True


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
    """The reference's sharding constraint.  Under explicit SPMD a rank's
    activation is already laid out by the code that made it, so this
    returns ``x`` as it is."""
    return x
