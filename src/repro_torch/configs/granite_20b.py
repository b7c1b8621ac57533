"""granite-20b [dense] — llama-arch code model with MQA (kv=1).

52L d_model=6144 48H (kv=1) d_ff=24576 vocab=49152 [arXiv:2405.04324].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    act="gelu",  # GPT-BigCode-style 2-matrix MLP (brings totals to ~20B)
)
