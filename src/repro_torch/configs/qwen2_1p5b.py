"""Qwen2-1.5B [arXiv:2407.10671]: 28L, d=1536, 12H (GQA kv=2), d_ff=8960,
vocab=151936, QKV bias."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        num_layers=28,
        d_model=1536,
        num_heads=12,           # padded to 16
        num_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1000000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke", family="dense", num_layers=3, d_model=48,
        num_heads=6, num_kv_heads=2, head_dim=8, d_ff=112, vocab_size=173,
        qkv_bias=True, tie_embeddings=True, head_pad_multiple=4,
        vocab_pad_multiple=16, attn_chunk=16, compute_dtype="float32",
        remat="none",
    )
