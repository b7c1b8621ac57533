"""Assigned input-shape set (same 4 shapes for every LM arch).

``train_*`` lowers train_step; ``prefill_*`` lowers the serving prefill;
``decode_*`` / ``long_*`` lower serve_step (one new token against a KV
cache of seq_len).  long_500k applies only to sub-quadratic archs
(SSM / hybrid) — full-attention archs skip it (DESIGN.md §6).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable(arch_cfg, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a valid cell, and why not if not."""
    if shape.name == "long_500k":
        subquad = any(k == "mamba" for k in arch_cfg.block_pattern) or (
            arch_cfg.long_window is not None
        )
        if not subquad:
            return False, "pure full-attention arch: O(S^2) at 500k — skipped per assignment"
    return True, ""
