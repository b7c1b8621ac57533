"""minicpm3-4b [dense] — MLA (multi-head latent attention).

62L d_model=2560 40H d_ff=6400 vocab=73448 [hf:openbmb/MiniCPM3-4B].
MLA dims follow the MiniCPM3 defaults: q_lora 768, kv_lora 256,
rope 32, nope 64, v_head 64.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab=73448,
    attn_kind="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_rope_dim=32,
    qk_nope_dim=64,
    v_head_dim=64,
)
