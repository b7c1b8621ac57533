"""Architecture registry: the port's copy of the reference's 10 model
configurations (``repro/configs``), as data; ``models/transformer.py``
serves every one of them.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.shapes import SHAPES, ShapeConfig, applicable  # noqa: F401

ARCHS = {
    "whisper-small": "whisper_small",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "minicpm3-4b": "minicpm3_4b",
    "qwen3-8b": "qwen3_8b",
    "granite-20b": "granite_20b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "kimi-k2-1t-a32b": "kimi_k2",
    "llama4-scout-17b-a16e": "llama4_scout",
    "internvl2-26b": "internvl2_26b",
    "mamba2-1.3b": "mamba2_1_3b",
}


def get_config(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.CONFIG


def all_archs() -> list[str]:
    return list(ARCHS)
