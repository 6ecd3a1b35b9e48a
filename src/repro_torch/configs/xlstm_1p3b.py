"""xLSTM-1.3B [arXiv:2405.04517]: 48 blocks, d=2048, 4 heads, vocab=50304,
d_ff=0 (blocks carry their own projections) — mLSTM blocks with sLSTM every
8th (the paper's 7:1 ratio).

Attention-free: no KV cache exists; state is O(1) per sequence (matrix
memory [dv, dk] per head) -> long_500k runs trivially.  Paged-KV is
inapplicable (DESIGN.md §5 Arch-applicability); UMap applies to weight
paging and the data pipeline."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=4,
        num_kv_heads=4,
        head_dim=512,
        d_ff=0,
        vocab_size=50304,
        slstm_every=8,
        mlstm_proj_factor=2.0,
        mlstm_qk_factor=0.5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="ssm", num_layers=4, d_model=32,
        num_heads=2, num_kv_heads=2, head_dim=16, d_ff=0, vocab_size=131,
        slstm_every=4, head_pad_multiple=2, vocab_pad_multiple=16,
        attn_chunk=16, mlstm_chunk=8, compute_dtype="float32", remat="none",
    )
