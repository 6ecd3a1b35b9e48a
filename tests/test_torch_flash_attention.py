"""PyTorch port: flash attention's plain version against the JAX package.

Inputs come from a numpy seed and feed both packages.  The JAX side runs its
Pallas kernel in interpret mode (``block_q=16, block_k=32``, so the tile
skip and the ragged padding path both run) and its jnp oracle, over the
sweep of ``tests/test_kernels.py``; tolerances are that file's (fp32 2e-5,
bf16 3e-2).  The port's plain version is what ``impl="auto"`` runs for a
CPU tensor; ``test_torch_cuda.py`` holds the CUDA kernel against it on the
card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref as torch_flash_ref

TOL = dict(float32=dict(atol=2e-5, rtol=2e-5),
           bfloat16=dict(atol=3e-2, rtol=3e-2))
TORCH_DTYPE = dict(float32=torch.float32, bfloat16=torch.bfloat16)
# the JAX oracle, jitted: one compile per shape instead of one per jnp op
jax_flash_attention_ref = jax.jit(flash_attention_ref, static_argnames=("causal", "window"))


def to_f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def torch_inputs(seed, dtype, b, h, kvh, sq, sk, d):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d))]
    return arrs, tuple(torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrs)


def flash_inputs(seed, dtype, b, h, kvh, sq, sk, d):
    """Same numbers for both packages: (jax q, k, v), (torch q, k, v)."""
    arrs, tt = torch_inputs(seed, dtype, b, h, kvh, sq, sk, d)
    # numpy rounds to bf16 to nearest even, as JAX and torch do; casting on
    # the host spares JAX a compiled cast per shape
    return tuple(jnp.asarray(a.astype(jnp.dtype(dtype))) for a in arrs), tt


# (b, h, kvh, sq, sk, d, causal): tests/test_kernels.py's sweep, causal only
# where Sq == Sk (its harness skips the other causal cases)
SWEEP = [
    (1, 4, 4, 32, 32, 16, True), (1, 4, 4, 32, 32, 16, False),       # MHA square
    (2, 8, 2, 64, 64, 32, True), (2, 8, 2, 64, 64, 32, False),       # GQA
    (1, 4, 1, 48, 80, 64, False),                                    # MQA, ragged
    (2, 2, 2, 16, 128, 128, False),                                  # long KV, wide head
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,sq,sk,d,causal", SWEEP)
def test_flash_plain_matches_jax_kernel_and_ref(dtype, b, h, kvh, sq, sk, d, causal):
    jx, tt = flash_inputs(0, dtype, b, h, kvh, sq, sk, d)
    got = flash_ops.flash_attention(*tt, causal=causal)      # CPU tensors -> plain
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (b, h, sq, d)
    kern = jax_flash_attention(*jx, causal=causal, block_q=16, block_k=32, interpret=True)
    ref = jax_flash_attention_ref(*jx, causal=causal)
    np.testing.assert_allclose(to_f32(got), to_f32(kern), **TOL[dtype])
    np.testing.assert_allclose(to_f32(got), to_f32(ref), **TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_sliding_window_matches_jax(causal):
    jx, tt = flash_inputs(1, "float32", 1, 2, 2, 64, 64, 16)
    got = flash_ops.flash_attention(*tt, causal=causal, window=8)
    kern = jax_flash_attention(*jx, causal=causal, window=8, block_q=16, block_k=16,
                               interpret=True)
    ref = jax_flash_attention_ref(*jx, causal=causal, window=8)
    np.testing.assert_allclose(to_f32(got), to_f32(kern), **TOL["float32"])
    np.testing.assert_allclose(to_f32(got), to_f32(ref), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,nh,kvh", [(16, 9, 3), (16, 12, 2), (4, 3, 1)])
def test_flash_plain_padded_heads_are_zero(dtype, h, nh, kvh):
    """num_heads < H (smollm 9 of 16 over 3 KV heads, qwen2 12 of 16 over
    2): real heads as the JAX oracle over q[:, :num_heads], whose grouping
    h // (num_heads // KVH) is make_qh_to_kv_map's; padded heads zero."""
    jx, tt = flash_inputs(2, dtype, 1, h, kvh, 40, 40, 32)
    got = flash_ops.flash_attention(*tt, num_heads=nh)
    ref = jax_flash_attention_ref(jx[0][:, :nh], *jx[1:])
    np.testing.assert_allclose(to_f32(got[:, :nh]), to_f32(ref), **TOL[dtype])
    assert (got[:, nh:] == 0).all()


def test_flash_plain_reads_strided_views():
    """The model passes [B,S,H,D] tensors as transpose(1, 2) views."""
    _, (q, k, v) = torch_inputs(3, "float32", 2, 4, 2, 24, 24, 16)
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    assert not qs.is_contiguous()
    torch.testing.assert_close(flash_ops.flash_attention(qs, ks, vs),
                               flash_ops.flash_attention(q, k, v), rtol=0, atol=0)


def test_flash_impl_switch():
    _, tt = torch_inputs(4, "float32", 1, 4, 2, 16, 16, 16)
    torch.testing.assert_close(flash_ops.flash_attention(*tt, impl="ref"),
                               torch_flash_ref(*tt), rtol=0, atol=0)
    torch.testing.assert_close(flash_ops.flash_attention(*tt, impl="auto"),
                               torch_flash_ref(*tt), rtol=0, atol=0)
    with pytest.raises(ValueError):
        flash_ops.flash_attention(*tt, impl="cuda")      # CPU tensors: no kernel
    with pytest.raises(ValueError):
        flash_ops.flash_attention(*tt, impl="pallas")
