"""deepseek-coder-33b [dense] — llama-arch GQA.

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256 [arXiv:2401.14196].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab=32256,
    rope_theta=100_000.0,
)
