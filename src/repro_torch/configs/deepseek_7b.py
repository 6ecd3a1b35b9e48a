"""DeepSeek-7B [arXiv:2401.02954]: 30L, d=4096, 32H (MHA: kv=32),
d_ff=11008, vocab=102400 — llama architecture, full MHA (heaviest KV per
token of the assigned dense archs: the best case for paged KV)."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        family="dense",
        num_layers=30,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,        # divisible by 16 -> KV genuinely sharded
        head_dim=128,
        d_ff=11008,
        vocab_size=102400,
        rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", family="dense", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=176, vocab_size=241,
        head_pad_multiple=4, vocab_pad_multiple=16, attn_chunk=16,
        compute_dtype="float32", remat="none",
    )
