"""Llama-3-8B [arXiv:2407.21783]: 32L, d=4096, 32H (GQA kv=8), d_ff=14336,
vocab=128256, RoPE theta 5e5."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,         # < 16 -> replicated KV over the model axis
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-smoke", family="dense", num_layers=3, d_model=64,
        num_heads=8, num_kv_heads=2, head_dim=8, d_ff=160, vocab_size=251,
        rope_theta=500000.0, head_pad_multiple=4, vocab_pad_multiple=16,
        attn_chunk=16, compute_dtype="float32", remat="none",
    )
