"""Phi-3.5-MoE (42B/A6.6B) [hf:microsoft/Phi-3.5-MoE-instruct]: 32L, d=4096,
32H (GQA kv=8), d_ff=6400, vocab=32064, MoE 16 experts top-2.

16 experts divide the 16-way model axis exactly -> expert-parallel (EP)
sharding: one expert per model shard."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab_size=32064,
        num_experts=16,
        top_k=2,
        moe_sharding="ep",
        rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi-moe-smoke", family="moe", num_layers=3, d_model=48,
        num_heads=4, num_kv_heads=2, head_dim=12, d_ff=64, vocab_size=157,
        num_experts=4, top_k=2, moe_sharding="ep", capacity_factor=4.0,
        head_pad_multiple=4, vocab_pad_multiple=16, attn_chunk=16,
        compute_dtype="float32", remat="none",
    )
