"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table config).

61L d_model=7168 64H (GQA kv=8) vocab=163840, MoE 384 experts top-8,
expert d_ff=2048, +1 shared expert [arXiv:2501.kimi2].  head_dim=128
(decoupled from d_model/heads=112 for MXU alignment — noted).  Adam
state for 1T params exceeds pod HBM; the training recipe for this arch
defaults to Adafactor + bf16 params (EXPERIMENTS.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,           # expert hidden dim per assignment
    vocab=163840,
    n_experts=384,
    topk=8,
    moe_d_ff=2048,
    n_shared_experts=1,
    shared_d_ff=2048,
)
