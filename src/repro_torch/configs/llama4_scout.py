"""llama4-scout-17b-a16e [moe] — MoE 16 experts top-1 + shared expert.

48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048
[hf:meta-llama/Llama-4-Scout-17B-16E].  Early-fusion multimodality is
out of scope for the LM backbone cells (text path only).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    topk=1,
    moe_d_ff=8192,
    n_shared_experts=1,
    shared_d_ff=8192,
)
