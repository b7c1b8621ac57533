"""whisper-small [audio] — enc-dec, conv frontend stubbed.

12L d_model=768 12H (GQA kv=12) d_ff=3072 vocab=51865 [arXiv:2212.04356].
The audio conv frontend is a STUB: input_specs() provides precomputed
frame embeddings (B, 1500, d).  Positional: sinusoid on both stacks
(whisper's decoder uses learned positions up to 448; we use sinusoid so
the assigned 32k-seq stress shapes are well-defined — noted in DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    encoder_layers=12,
    frontend="audio_stub",
    frontend_seq=1500,
    pos_embed="sinusoid",
    act="gelu",
    norm="layernorm",
)
