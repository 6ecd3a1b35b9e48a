"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M]: 30L, d=576, 9H (GQA kv=3),
d_ff=1536, vocab=49152 — llama-architecture small model; also the end-to-end
training example (examples/train_smollm.py)."""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        num_layers=30,
        d_model=576,
        num_heads=9,            # padded to 16 for the 16-way model axis
        num_kv_heads=3,
        head_dim=64,
        d_ff=1536,
        vocab_size=49152,
        rope_theta=10000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke", family="dense", num_layers=3, d_model=48,
        num_heads=3, num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=199,
        tie_embeddings=True, head_pad_multiple=4, vocab_pad_multiple=16,
        attn_chunk=16, compute_dtype="float32", remat="none",
    )
