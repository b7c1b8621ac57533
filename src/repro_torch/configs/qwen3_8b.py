"""qwen3-8b [dense] — GQA + per-head qk-norm.

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936 [hf:Qwen/Qwen3-8B].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
