"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2
[arXiv:2403.19887].  Pattern group = 8 layers (attn at position 4, the
rest Mamba-2/SSD — we use SSD for all SSM blocks, DESIGN.md §3); MoE on
every other layer (even pattern positions).  At long_500k the attention
layers switch to a 4k local window (ring cache) — Mamba layers carry the
long-range state.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    n_experts=16,
    topk=2,
    moe_d_ff=24576,
    moe_pattern=(0, 2, 4, 6),
    block_pattern=("mamba", "mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba"),
    ssm_state=128,
    ssm_head_dim=64,
    long_window=4096,
)
