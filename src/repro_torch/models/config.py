"""Model configuration covering all 10 assigned architectures: the
port's copy of ``repro/models/config.py`` (plain Python, unchanged).

One frozen dataclass parameterises the unified transformer stack
(models/transformer.py): dense / GQA / MQA / MLA attention, qk-norm,
MoE (+ shared experts), Mamba-2 SSD blocks and hybrid interleaves,
encoder-decoder (whisper) and prefix-embedding VLM stubs; the port
serves every kind.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128

    # --- attention variant ---------------------------------------------
    attn_kind: str = "gqa"          # "gqa" | "mla"
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    pos_embed: str = "rope"         # "rope" | "sinusoid"
    window: int | None = None       # local-attention width (None = full)
    long_window: int | None = None  # window used only for long_500k cells

    # --- MLA (multi-head latent attention) ------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 32
    qk_nope_dim: int = 64
    v_head_dim: int = 0             # 0 -> head_dim

    # --- MoE -------------------------------------------------------------
    n_experts: int = 0
    topk: int = 0
    moe_d_ff: int = 0               # expert hidden dim (0 -> d_ff)
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    moe_pattern: Tuple[int, ...] = ()  # which layers in the block pattern are MoE
    capacity_factor: float = 1.25

    # --- block pattern / SSM ---------------------------------------------
    block_pattern: Tuple[str, ...] = ("attn",)  # cycled across layers
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4

    # --- encoder-decoder / modality stub ---------------------------------
    encoder_layers: int = 0          # > 0 => enc-dec (whisper)
    frontend: str = "none"           # "none" | "audio_stub" | "vision_stub"
    frontend_seq: int = 0            # stub embedding sequence length
    prefix_len: int = 0              # VLM: patch-embedding prefix length

    # --- misc --------------------------------------------------------------
    act: str = "silu"                # "silu" | "gelu"
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    vocab_pad: int = 128

    # ------------------------------------------------------------------ #
    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab, self.vocab_pad)

    @property
    def q_dim(self) -> int:
        if self.attn_kind == "mla":
            return self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.n_heads * self.head_dim

    @property
    def v_dim_per_head(self) -> int:
        if self.attn_kind == "mla":
            return self.v_head_dim or self.head_dim
        return self.head_dim

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def pattern_len(self) -> int:
        return len(self.block_pattern)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.pattern_len == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern {self.block_pattern}"
        )
        return self.n_layers // self.pattern_len

    def layer_kinds(self) -> Tuple[Tuple[str, bool], ...]:
        """Per-pattern-position (kind, is_moe)."""
        out = []
        for i, kind in enumerate(self.block_pattern):
            is_moe = self.n_experts > 0 and (
                not self.moe_pattern or i in self.moe_pattern
            )
            out.append((kind, is_moe and kind != "mamba"))
        return tuple(out)

    # --- parameter counting (for roofline MODEL_FLOPS) -------------------
    def param_counts(self) -> dict:
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        counts = {"embed": self.padded_vocab * d}
        attn = 0
        if self.attn_kind == "mla":
            qr = self.q_lora_rank or d
            attn += d * qr + qr * self.q_dim                      # q down/up
            attn += d * (self.kv_lora_rank + self.qk_rope_dim)    # kv down
            attn += self.kv_lora_rank * self.n_heads * (
                self.qk_nope_dim + self.v_dim_per_head
            )
            attn += self.n_heads * self.v_dim_per_head * d        # out
        else:
            attn += d * h * hd + 2 * d * kv * hd + h * hd * d
        dense_ffn = 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
        moe_ffn = self.n_experts * 3 * d * self.expert_ff + d * self.n_experts
        moe_ffn += self.n_shared_experts * 3 * d * (self.shared_d_ff or self.expert_ff)
        mamba = (
            d * (2 * self.d_inner + 2 * self.ssm_state + self.ssm_heads)  # in_proj-ish
            + self.d_inner * d
            + self.conv_kernel * self.d_inner
        )
        per_pattern = 0
        active_per_pattern = 0
        for kind, is_moe in self.layer_kinds():
            if kind == "attn":
                per_pattern += attn
                active_per_pattern += attn
            else:
                per_pattern += mamba
                active_per_pattern += mamba
            if kind == "mamba":
                continue
            if is_moe:
                per_pattern += moe_ffn
                active = (
                    (self.topk + self.n_shared_experts) * 3 * d * self.expert_ff
                    + d * self.n_experts
                )
                active_per_pattern += active
            else:
                per_pattern += dense_ffn
                active_per_pattern += dense_ffn
        counts["blocks"] = self.n_groups * per_pattern
        counts["blocks_active"] = self.n_groups * active_per_pattern
        if self.encoder_layers:
            counts["encoder"] = self.encoder_layers * (attn + dense_ffn)
        counts["lm_head"] = 0 if self.tie_embeddings else self.padded_vocab * d
        counts["total"] = (
            counts["embed"] + counts["blocks"] + counts.get("encoder", 0)
            + counts["lm_head"]
        )
        counts["active"] = (
            counts["embed"] + counts["blocks_active"] + counts.get("encoder", 0)
            + counts["lm_head"]
        )
        return counts

    def tiny(self, **overrides) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        small = dict(
            n_layers=self.pattern_len * 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128,
            vocab=512,
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_rope_dim=8 if self.attn_kind == "mla" else self.qk_rope_dim,
            qk_nope_dim=16 if self.attn_kind == "mla" else self.qk_nope_dim,
            v_head_dim=16 if self.attn_kind == "mla" else 0,
            n_experts=min(self.n_experts, 4),
            topk=min(self.topk, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            shared_d_ff=64 if self.shared_d_ff else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            # Drop-free capacity so decode == teacher-forced forward exactly
            # (production configs keep 1.25 and accept routed drops).
            capacity_factor=float(max(self.n_experts, 1)),
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_seq=16 if self.frontend_seq else 0,
            prefix_len=4 if self.prefix_len else 0,
            name=self.name + "-tiny",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
