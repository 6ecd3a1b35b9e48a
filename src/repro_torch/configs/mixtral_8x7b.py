"""Mixtral-8x7B [arXiv:2401.04088]: 32L, d=4096, 32H (GQA kv=8), d_ff=14336,
vocab=32000, MoE 8 experts top-2, sliding-window attention (W=4096).

8 experts don't divide the 16-way model axis -> TP-MoE sharding (expert FFN
dim sharded, experts replicated).  SWA makes it sub-quadratic: long_500k runs
with a window-sized ring cache — the sliding-window eviction policy is the
UMap user-defined-eviction story at the KV level (DESIGN.md §5)."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        num_experts=8,
        top_k=2,
        moe_sharding="tp",
        sliding_window=4096,
        rope_theta=1000000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="moe", num_layers=3, d_model=48,
        num_heads=4, num_kv_heads=2, head_dim=12, d_ff=96, vocab_size=163,
        num_experts=4, top_k=2, moe_sharding="tp", sliding_window=8,
        capacity_factor=4.0, head_pad_multiple=4, vocab_pad_multiple=16,
        attn_chunk=16, compute_dtype="float32", remat="none",
    )
