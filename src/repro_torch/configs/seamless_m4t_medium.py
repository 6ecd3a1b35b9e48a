"""SeamlessM4T-medium [arXiv:2308.11596]: 12L enc + 12L dec, d=1024, 16H
(MHA), d_ff=4096, vocab=256206.  Multimodal encoder-decoder; the speech
frontend is a STUB — input_specs() provides precomputed frame embeddings
(per the assignment, the backbone only)."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="encdec",
        num_layers=12,          # decoder layers
        enc_layers=12,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=256206,      # padded to 256256 (divisible by 16)
        act="gelu",
        rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke", family="encdec", num_layers=2, enc_layers=2,
        d_model=48, num_heads=4, num_kv_heads=4, head_dim=12, d_ff=96,
        vocab_size=307, act="gelu", head_pad_multiple=4, vocab_pad_multiple=16,
        attn_chunk=16, compute_dtype="float32", remat="none",
    )
