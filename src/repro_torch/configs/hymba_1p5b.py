"""Hymba-1.5B [arXiv:2411.13676]: 32L, d=1600, 25H (GQA kv=5), d_ff=5504,
vocab=32001, ssm_state=16 — parallel attention + Mamba heads per layer,
sliding-window attention with 3 full-attention layers (first/middle/last),
128 learnable meta tokens."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,           # padded to 32 for the 16-way model axis
        num_kv_heads=5,         # < 16 -> replicated KV (DESIGN.md §7)
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,       # padded to 32256
        ssm_state=16,
        mamba_expand=2,
        sliding_window=1024,
        global_layers=(0, 16, 31),
        num_meta_tokens=128,
        rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", family="hybrid", num_layers=4, d_model=64,
        num_heads=5, num_kv_heads=1, head_dim=8, d_ff=128, vocab_size=211,
        ssm_state=4, sliding_window=8, global_layers=(0, 3), num_meta_tokens=4,
        head_pad_multiple=4, vocab_pad_multiple=16, attn_chunk=16, ssm_chunk=16,
        compute_dtype="float32", remat="none",
    )
