"""mamba2-1.3b [ssm] — attention-free SSD (state-space duality).

48L d_model=2048 d_ff=0 vocab=50280 ssm_state=128 [arXiv:2405.21060].
Pure Mamba-2 blocks (no MLP sublayer), d_inner = 2*d_model, head_dim 64.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    n_layers=48,
    d_model=2048,
    n_heads=1,
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    block_pattern=("mamba",),
    ssm_state=128,
    ssm_head_dim=64,
    tie_embeddings=True,
)
