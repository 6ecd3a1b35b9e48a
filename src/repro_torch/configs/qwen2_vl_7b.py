"""Qwen2-VL-7B [arXiv:2409.12191]: 28L, d=3584, 28H (GQA kv=4), d_ff=18944,
vocab=152064 — M-RoPE (temporal/height/width sections 16/24/24 of the 64
frequency pairs), dynamic resolution.  The vision frontend is a STUB:
input_specs() provides precomputed patch embeddings + 3D positions (the
assignment specifies backbone only)."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,           # padded to 32
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        mrope_sections=(16, 24, 24),
        input_mode="embeds",
        rope_theta=1000000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2vl-smoke", family="vlm", num_layers=3, d_model=48,
        num_heads=7, num_kv_heads=1, head_dim=16, d_ff=112, vocab_size=179,
        qkv_bias=True, mrope_sections=(4, 2, 2), input_mode="embeds",
        head_pad_multiple=4, vocab_pad_multiple=16, attn_chunk=16,
        compute_dtype="float32", remat="none",
    )
