"""internvl2-26b [vlm] — InternLM2-20B language backbone; InternViT
frontend is a STUB (input_specs() provides 256 precomputed patch
embeddings as a prefix).

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 [arXiv:2404.16821].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92553,
    frontend="vision_stub",
    prefix_len=256,
)
