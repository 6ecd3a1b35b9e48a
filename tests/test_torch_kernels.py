"""PyTorch port: kernels' plain versions against the JAX package's kernels.

Inputs come from a numpy seed and feed both packages.  The JAX side runs
its Pallas kernels in interpret mode and its jnp oracles, as
``tests/test_kernels.py`` does; tolerances are that file's (fp32 2e-5,
bf16 3e-2).  The port's plain versions are what ``impl="auto"`` runs for a
CPU tensor.  ``test_torch_cuda.py`` holds the CUDA kernels against these
plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.page_gather.kernel import page_gather as jax_page_gather
from repro.kernels.page_gather.kernel import page_scatter as jax_page_scatter
from repro.kernels.page_gather.ref import page_gather_ref as jax_page_gather_ref
from repro.kernels.page_gather.ref import page_scatter_ref as jax_page_scatter_ref
from repro.kernels.paged_attention.kernel import paged_attention as jax_paged_attention
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_paged_attention_ref
from repro_torch.kernels.page_gather import ops as gather_ops
from repro_torch.kernels.paged_attention import ops as attn_ops
from repro_torch.kernels.paged_attention.kernel import MAX_SPLIT_PAGES, MAX_SPLITS, split_plan
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

TOL = dict(float32=dict(atol=2e-5, rtol=2e-5),
           bfloat16=dict(atol=3e-2, rtol=3e-2))
TORCH_DTYPE = dict(float32=torch.float32, bfloat16=torch.bfloat16)


def to_f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def attention_inputs(seed, dtype, b, h, kvh, d, pages, ps, pps, lengths=None):
    """Same numbers for both packages: (jax args, torch args)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((pages, ps, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((pages, ps, kvh, d)).astype(np.float32)
    table = rng.choice(pages, size=(b, pps), replace=False).astype(np.int32)
    if lengths is None:
        lengths = rng.integers(1, pps * ps + 1, size=b)
    lengths = np.asarray(lengths, np.int32)
    jx = tuple(jnp.asarray(a).astype(dtype) for a in (q, kp, vp)) + (
        jnp.asarray(table), jnp.asarray(lengths))
    tt = tuple(torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in (q, kp, vp)) + (
        torch.from_numpy(table), torch.from_numpy(lengths))
    return jx, tt


# ------------------------------------------------------------ paged attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,d,pages,ps,pps", [
    (2, 4, 4, 32, 16, 8, 4),
    (3, 8, 2, 64, 32, 16, 6),
])
def test_paged_attention_plain_matches_jax_kernel_and_ref(dtype, b, h, kvh, d, pages, ps, pps):
    jx, tt = attention_inputs(0, dtype, b, h, kvh, d, pages, ps, pps)
    got = attn_ops.paged_attention(*tt)                 # CPU tensors -> plain
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (b, h, d)
    kern = jax_paged_attention(*jx, interpret=True)
    ref = jax_paged_attention_ref(*jx)
    np.testing.assert_allclose(to_f32(got), to_f32(kern), **TOL[dtype])
    np.testing.assert_allclose(to_f32(got), to_f32(ref), **TOL[dtype])


@pytest.mark.parametrize("ps", [8, 16])
def test_paged_attention_length_zero_row_gives_zeros_like_the_kernel(ps):
    b, h, kvh, d, pps = 3, 4, 2, 16, 3
    jx, tt = attention_inputs(1, "float32", b, h, kvh, d, 12, ps, pps,
                              lengths=[ps + 3, 0, 1])
    got = attn_ops.paged_attention(*tt)
    kern = jax_paged_attention(*jx, interpret=True)
    np.testing.assert_allclose(to_f32(got), to_f32(kern), **TOL["float32"])
    assert (got[1] == 0).all()
    # the JAX oracle differs only on the empty row (mean of v there)
    ref = jax_paged_attention_ref(*jx)
    np.testing.assert_allclose(to_f32(got)[[0, 2]], to_f32(ref)[[0, 2]], **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_padded_heads_are_zero(dtype):
    """num_heads < H: real heads as the kernel over q[:, :num_heads],
    padded heads zero (smollm's 9 heads padded to 16, 3 KV heads)."""
    b, h, nh, kvh, d = 2, 16, 9, 3, 32
    jx, tt = attention_inputs(2, dtype, b, h, kvh, d, 20, 8, 4)
    got = attn_ops.paged_attention(*tt, num_heads=nh)
    q_real = jx[0][:, :nh]
    kern = jax_paged_attention(q_real, *jx[1:], interpret=True)
    np.testing.assert_allclose(to_f32(got[:, :nh]), to_f32(kern), **TOL[dtype])
    assert (got[:, nh:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_qwen2_grouping(dtype):
    """qwen2-1.5b's grouping: 12 real heads padded to 16 over 2 KV heads
    (head i reads KV head i // 6), D 128, on a tiny pool (page 8, 4 pages
    a sequence, one length 0).  Real heads as the Pallas kernel over
    q[:, :12]; padded heads zero."""
    b, h, nh, kvh, d = 3, 16, 12, 2, 128
    jx, tt = attention_inputs(7, dtype, b, h, kvh, d, 12, 8, 4, lengths=[32, 0, 13])
    got = attn_ops.paged_attention(*tt, num_heads=nh)
    kern = jax_paged_attention(jx[0][:, :nh], *jx[1:], interpret=True)
    np.testing.assert_allclose(to_f32(got[:, :nh]), to_f32(kern), **TOL[dtype])
    assert (got[:, nh:] == 0).all() and (got[1] == 0).all()


@pytest.mark.parametrize("pps,ps,b,kvh,want", [
    (264, 16, 4, 2, (8, 33)),        # qwen2-1.5b decode: 8 pages (128 tokens) a split
    (128, 16, 8, 3, (8, 16)),        # smollm-135m at a 2048-token context
    (32, 16, 8, 3, (8, 4)),          # smollm-135m serving table
    (4, 8, 3, 2, (4, 1)),            # a table narrower than one split
    (64, 16, 128, 8, (64, 1)),       # B * KVH >= 4 blocks per SM: one split
    (512, 16, 8, 3, (24, 22)),       # 8 k-token table: 22 blocks per (sequence, KV head)
    (1 << 20, 16, 1, 1, (1024, 1024)),
])
def test_paged_attention_split_plan(pps, ps, b, kvh, want):
    """Shapes alone choose the split: about 4 blocks per SM of 132 over the
    table, at least 128 tokens a split, every page in exactly one split."""
    per, splits = split_plan(pps, ps, b, kvh, 132)
    assert (per, splits) == want
    assert (splits - 1) * per < pps <= splits * per
    assert per <= MAX_SPLIT_PAGES and splits <= MAX_SPLITS
    with pytest.raises(ValueError):
        split_plan(MAX_SPLITS * MAX_SPLIT_PAGES + 1, ps, b, kvh, 132)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_window_matches_jax_decode_attention(dtype):
    """The plain windowed version against the JAX package's paged decode
    (``_gather_paged`` + ``decode_attention``, which applies the window):
    a window of 6 over pages of 4 (not a page multiple), lengths below, at
    and past the window, 5 query heads a KV head."""
    from repro.models.blocks import _gather_paged as jax_gather_paged
    from repro.models.layers import decode_attention as jax_decode_attention

    window = 6
    jx, tt = attention_inputs(11, dtype, 4, 10, 2, 16, 40, 4, 9, lengths=[3, 6, 17, 36])
    q, kp, vp, table, lengths = jx
    kc, vc, kpos, cur = jax_gather_paged({"k_pool": kp, "v_pool": vp, "table": table,
                                          "len": lengths})
    want = jax_decode_attention(q[:, None], kc, vc, kpos, cur, window)[:, 0]
    got = attn_ops.paged_attention(*tt, window=window)
    np.testing.assert_allclose(to_f32(got), to_f32(want), **TOL[dtype])
    # the window binds: without it rows 2 and 3 differ
    full = attn_ops.paged_attention(*tt)
    torch.testing.assert_close(full[:2], got[:2], rtol=0, atol=0)
    assert not torch.allclose(full[2:].float(), got[2:].float(), atol=1e-2)


@pytest.mark.parametrize("pps,ps,window,want", [
    (300, 16, None, (18, 17)),      # mixtral's heads (B 4, KVH 8) over a 4.8 k table
    (300, 16, 4096, (16, 17)),      # its window: 257 of the 300 pages
    (264, 16, 4096, (16, 17)),
    (512, 16, 1024, (8, 9)),        # a 1024 window: 65 pages of 16
    (512, 16, 1025, (8, 9)),        # 65 pages: ceil(1024 / 16) + 1
    (200, 16, 8192, (12, 17)),      # a window wider than the table: the table's plan
    (8, 4, 6, (3, 1)),              # ceil(5 / 4) + 1 = 3 pages, one split
])
def test_paged_attention_split_plan_covers_the_window(pps, ps, window, want):
    """With a window the splits cover only the pages the window can span,
    min(pps, ceil((window - 1) / ps) + 1), still from shapes alone (B 4,
    KVH 8, 132 SMs)."""
    from repro_torch.kernels.paged_attention.kernel import visible_pages

    span = visible_pages(pps, ps, window)
    assert span == (pps if window is None else min(pps, -(-(window - 1) // ps) + 1))
    per, splits = split_plan(pps, ps, 4, 8, 132, window)
    assert (per, splits) == want
    assert (splits - 1) * per < span <= splits * per


def test_paged_attention_impl_switch():
    _, tt = attention_inputs(3, "float32", 2, 4, 2, 16, 8, 4, 2)
    torch.testing.assert_close(attn_ops.paged_attention(*tt, impl="ref"),
                               paged_attention_ref(*tt), rtol=0, atol=0)
    with pytest.raises(ValueError):
        attn_ops.paged_attention(*tt, impl="cuda")      # CPU tensors: no kernel
    with pytest.raises(ValueError):
        attn_ops.paged_attention(*tt, impl="pallas")


# ---------------------------------------------------------- gather / scatter


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,elems,seed", [(4, 128, 0), (17, 256, 1), (32, 512, 2)])
def test_page_gather_scatter_plain_match_jax_bitwise(dtype, p, elems, seed):
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((p, elems)).astype(np.float32)
    n = int(rng.integers(1, p + 1))
    ids = rng.choice(p, size=n, replace=False).astype(np.int32)
    pages = rng.standard_normal((n, elems)).astype(np.float32)
    jpool, jpages = (jnp.asarray(a).astype(dtype) for a in (pool, pages))
    tpool, tpages = (torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in (pool, pages))
    tids = torch.from_numpy(ids)

    got = gather_ops.page_gather(tpool, tids)
    for want in (jax_page_gather(jpool, jnp.asarray(ids), interpret=True),
                 jax_page_gather_ref(jpool, jnp.asarray(ids))):
        np.testing.assert_array_equal(to_f32(got), to_f32(want))

    want_ref = jax_page_scatter_ref(jpool, jnp.asarray(ids), jpages)
    want_kern = jax_page_scatter(jpool, jnp.asarray(ids), jpages, interpret=True)
    out = gather_ops.page_scatter(tpool, tids, tpages)
    assert out is tpool                                # in place
    np.testing.assert_array_equal(to_f32(out), to_f32(want_ref))
    np.testing.assert_array_equal(to_f32(out), to_f32(want_kern))


def test_gather_scatter_roundtrip():
    """UFFDIO_COPY semantics: install then read back the exact page."""
    pool = torch.zeros((8, 128), dtype=torch.float32)
    ids = torch.tensor([3, 5], dtype=torch.int32)
    pages = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 128)).astype(np.float32))
    gather_ops.page_scatter(pool, ids, pages)
    torch.testing.assert_close(gather_ops.page_gather(pool, ids), pages, rtol=0, atol=0)
    assert (pool[[0, 1, 2, 4, 6, 7]] == 0).all()
