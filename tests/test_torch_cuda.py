"""PyTorch port on the card: each CUDA kernel against its plain version.

Every test here is marked ``cuda`` and skips where ``torch.cuda`` finds no
card (the kernels have no CPU mode).  This file imports neither JAX nor the
JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances are the JAX package's kernel-test ones (fp32 2e-5, bf16 3e-2),
and each attention output row is also held to the plain row's norm
(``ROW_REL_TOL``); page copies are bitwise.  fp32 products are held in full
fp32 (TF32 off).
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.page_gather import kernel as copy_kernel
from repro_torch.kernels.page_gather import ops as gather_ops
from repro_torch.kernels.page_gather.ref import page_gather_ref, page_scatter_ref, take_fill
from repro_torch.kernels.paged_attention import ops as attn_ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

TOL = dict(float32=dict(atol=2e-5, rtol=2e-5),
           bfloat16=dict(atol=3e-2, rtol=3e-2))
TORCH_DTYPE = dict(float32=torch.float32, bfloat16=torch.bfloat16)
# per output row: ||out - ref|| / ||ref|| over D.  A row that averages many
# keys (a long decode context, a late row of a causal prompt) has a small |o|
# (~0.03 at 1-2 k keys), so TOL alone would let tens of percent of error through.
ROW_REL_TOL = dict(float32=2e-5, bfloat16=1e-2)

pytestmark = pytest.mark.cuda


def max_row_rel_err(got, want):
    """Largest relative error over the rows where ``want`` is not zero;
    rows where ``want`` is zero must be zero in ``got``."""
    diff = (got.float() - want.float()).norm(dim=-1)
    norm = want.float().norm(dim=-1)
    live = norm > 0
    assert (diff[~live] == 0).all()
    return (diff[live] / norm[live]).max().item()


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def attention_inputs(seed, dtype, device, b, h, kvh, d, pages, ps, pps, lengths=None):
    rng = np.random.default_rng(seed)
    dt = TORCH_DTYPE[dtype]
    q, kp, vp = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, dt)
                 for s in ((b, h, d), (pages, ps, kvh, d), (pages, ps, kvh, d)))
    table = rng.choice(pages, size=(b, pps), replace=False).astype(np.int32)
    if lengths is None:
        lengths = rng.integers(1, pps * ps + 1, size=b)
    return (q, kp, vp, torch.from_numpy(table).to(device),
            torch.from_numpy(np.asarray(lengths, np.int32)).to(device))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,nh,kvh,d,pages,ps,pps", [
    (8, 16, 9, 3, 64, 512, 16, 32),       # smollm-135m serving shapes
    (3, 8, 8, 2, 128, 64, 8, 6),
    (2, 4, 3, 1, 16, 16, 4, 3),           # smoke config: 3 heads padded to 4
])
def test_paged_attention_kernel_matches_plain(cuda, dtype, b, h, nh, kvh, d, pages, ps, pps):
    args = attention_inputs(4, dtype, cuda, b, h, kvh, d, pages, ps, pps)
    before = K.launch_counts["paged_attention"]
    got = attn_ops.paged_attention(*args, num_heads=nh)
    want = paged_attention_ref(*args, num_heads=nh)
    torch.cuda.synchronize()
    assert K.launch_counts["paged_attention"] == before + 1
    check_against_plain(got, want, dtype, nh, args[4].tolist())


def test_paged_attention_kernel_length_zero_and_long_context(cuda):
    args = attention_inputs(6, "float32", cuda, 4, 6, 2, 64, 600, 16, 128,
                            lengths=[2048, 0, 1, 1777])
    got = attn_ops.paged_attention(*args)
    check_against_plain(got, paged_attention_ref(*args), "float32", 6, [2048, 0, 1, 1777])
    assert (got[1] == 0).all()


def check_against_plain(got, want, dtype, nh, lengths):
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert max_row_rel_err(got[:, :nh], want[:, :nh]) <= ROW_REL_TOL[dtype]
    assert (got[:, nh:] == 0).all()
    for i, n in enumerate(lengths):
        if n == 0:
            assert (got[i] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_split_edges(cuda, dtype):
    """qwen2-1.5b's heads (12 real of 16 over 2 KV heads, D 128) at lengths
    on and around the edges of a split: 0, 1, one split -1 / exact / +1,
    the whole table."""
    from repro_torch.kernels.paged_attention.kernel import _num_sms, split_plan

    b, h, nh, kvh, d, ps, pps = 6, 16, 12, 2, 128, 16, 64
    per, splits = split_plan(pps, ps, b, kvh, _num_sms(cuda))
    assert splits > 1
    t = per * ps
    lengths = [0, 1, t - 1, t, t + 1, pps * ps]
    args = attention_inputs(11, dtype, cuda, b, h, kvh, d, 400, ps, pps, lengths)
    got = attn_ops.paged_attention(*args, num_heads=nh)
    check_against_plain(got, paged_attention_ref(*args, num_heads=nh), dtype, nh, lengths)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,nh,kvh,d,ps,pps", [
    (3, 4, 4, 4, 128, 16, 48),        # rep 1 (deepseek-7b)
    (3, 16, 9, 3, 64, 16, 48),        # rep 3 in 16 heads (smollm-135m)
    (3, 8, 8, 2, 128, 16, 48),        # rep 4 (llama3-8b's grouping)
    (3, 16, 12, 2, 128, 16, 48),      # rep 6 in 16 heads (qwen2-1.5b)
    (3, 8, 8, 1, 64, 8, 40),          # rep 8, page 8
    (3, 4, 3, 1, 16, 4, 70),          # smoke shapes: D 16, page 4
    (2, 8, 6, 2, 8, 8, 30),           # qwen2 smoke: D 8
    (2, 8, 8, 1, 256, 16, 24),        # D 256 with rep 8
    (2, 4, 4, 2, 10, 8, 20),          # D 10: rows not 16-byte aligned, no cp.async
    (64, 8, 8, 8, 64, 16, 4),         # B * KVH fills the card: one split
])
def test_paged_attention_kernel_heads_and_widths(cuda, dtype, b, h, nh, kvh, d, ps, pps):
    args = attention_inputs(12, dtype, cuda, b, h, kvh, d, b * pps + 3, ps, pps)
    got = attn_ops.paged_attention(*args, num_heads=nh)
    want = paged_attention_ref(*args, num_heads=nh)
    check_against_plain(got, want, dtype, nh, args[4].tolist())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,nh,kvh,d,ps,pps,window,lengths", [
    # hymba-1.5b: 25 real heads of 32 over 5 (rep 5), D 64, window 1024
    (6, 32, 25, 5, 64, 16, 128, 1024, [0, 1, 1000, 1024, 1025, 2048]),
    (4, 32, 25, 5, 64, 16, 128, 1024, [1023, 1031, 1900, 2040]),
    # mixtral-8x7b: 32 heads over 8, D 128, window 4096
    (4, 32, 32, 8, 128, 16, 300, 4096, [4095, 4096, 4097, 4800]),
    (3, 32, 32, 8, 128, 16, 300, 4096, [17, 2500, 4600]),
    # a window that is not a page multiple, across split edges
    (5, 8, 8, 2, 128, 16, 64, 300, [1, 299, 300, 301, 1024]),
])
def test_paged_attention_kernel_window(cuda, dtype, b, h, nh, kvh, d, ps, pps, window,
                                       lengths):
    """Windowed decode against the plain version, lengths below, at and far
    past the window: only positions [len - window, len) are visible."""
    args = attention_inputs(13, dtype, cuda, b, h, kvh, d, b * pps + 3, ps, pps, lengths)
    before = K.launch_counts["paged_attention"]
    got = attn_ops.paged_attention(*args, num_heads=nh, window=window)
    want = paged_attention_ref(*args, num_heads=nh, window=window)
    torch.cuda.synchronize()
    assert K.launch_counts["paged_attention"] == before + 1
    check_against_plain(got, want, dtype, nh, lengths)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_unaligned_pool(cuda, dtype):
    """A pool that does not start on 16 bytes takes the plain loads."""
    b, h, kvh, d, pages, ps, pps = 2, 8, 2, 64, 40, 16, 16
    args = list(attention_inputs(13, dtype, cuda, b, h, kvh, d, pages, ps, pps))
    for i in (1, 2):
        flat = torch.empty(args[i].numel() + 1, dtype=args[i].dtype, device=cuda)
        view = flat[1:].view(args[i].shape)
        view.copy_(args[i])
        assert view.data_ptr() % 16 != 0
        args[i] = view
    got = attn_ops.paged_attention(*args)
    check_against_plain(got, paged_attention_ref(*args), dtype, h, args[4].tolist())


def test_paged_attention_kernel_skips_out_of_pool_ids_past_the_length(cuda):
    """Table entries past the length may be anything, even outside the
    pool: they are never read."""
    b, h, kvh, d, pages, ps, pps = 4, 8, 2, 128, 300, 16, 64
    lengths = [5, 300, 17, 1000]
    args = list(attention_inputs(14, "bfloat16", cuda, b, h, kvh, d, pages, ps, pps, lengths))
    table = args[3].clone()
    for i, n in enumerate(lengths):
        used = -(-n // ps)
        junk = torch.tensor([-1, pages, pages + 10**6, -(10**6)], dtype=torch.int32, device=cuda)
        table[i, used:] = junk.repeat(pps)[: pps - used]
    got = attn_ops.paged_attention(*args[:3], table, args[4])
    torch.cuda.synchronize()
    check_against_plain(got, paged_attention_ref(*args), "bfloat16", h, lengths)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_all_lanes_empty(cuda, dtype):
    args = attention_inputs(15, dtype, cuda, 4, 16, 2, 128, 300, 16, 64, [0, 0, 0, 0])
    got = attn_ops.paged_attention(*args, num_heads=12)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and (got == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_is_deterministic(cuda, dtype):
    """The splits are merged in a fixed order: two calls agree bitwise (and
    with the plain version, at qwen2-1.5b's long-context decode)."""
    lengths = [3637, 2981, 2594, 1853]
    args = attention_inputs(16, dtype, cuda, 4, 16, 2, 128, 1100, 16, 264, lengths)
    first = attn_ops.paged_attention(*args, num_heads=12)
    second = attn_ops.paged_attention(*args, num_heads=12)
    assert torch.equal(first, second)
    check_against_plain(first, paged_attention_ref(*args, num_heads=12), dtype, 12, lengths)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("elems", [3072, 1000, 7])          # tail / unaligned rows
def test_page_copy_kernels_match_plain_bitwise(cuda, dtype, elems):
    rng = np.random.default_rng(5)
    p, n = 40, 13
    dt = TORCH_DTYPE[dtype]
    pool = torch.from_numpy(rng.standard_normal((p, elems)).astype(np.float32)).to(cuda, dt)
    ids = torch.from_numpy(rng.choice(p, size=n, replace=False).astype(np.int32)).to(cuda)
    pages = torch.from_numpy(rng.standard_normal((n, elems)).astype(np.float32)).to(cuda, dt)
    assert torch.equal(gather_ops.page_gather(pool, ids), pool.index_select(0, ids.long()))
    out = gather_ops.page_scatter(pool.clone(), ids, pages)
    assert torch.equal(out, pool.clone().index_copy_(0, ids.long(), pages))


def randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(TORCH_DTYPE[dtype])


def page_ids(pages, n, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randperm(pages, generator=g, device=device)[:n].to(torch.int32)


def run_copy(name, variant, *args):
    """One layered copy forced to ``variant``; checks that it was counted."""
    before = copy_kernel.copy_variant_counts[name][variant]
    out = getattr(copy_kernel, name)(*args, variant=variant)
    torch.cuda.synchronize()
    n = args[1].shape[0]
    assert copy_kernel.copy_variant_counts[name][variant] == before + (n > 0)
    return out


@pytest.mark.parametrize("variant", copy_kernel.VARIANTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers", [1, 3, 30])
@pytest.mark.parametrize("n", [0, 1, 13, 256])
def test_layered_copy_kernels_match_plain_bitwise(cuda, variant, dtype, layers, n):
    """smollm's 3072-element rows: one 8 KB chunk in bf16, two in fp32."""
    pool = randn((layers, 300, 3072), dtype, cuda, seed=n + layers)
    ids = page_ids(300, n, cuda, seed=n)
    pages = randn((layers, n, 3072), dtype, cuda, seed=7)
    got = run_copy("page_gather", variant, pool, ids)
    assert got.shape == (layers, n, 3072) and torch.equal(got, page_gather_ref(pool, ids))
    out = run_copy("page_scatter", variant, pool.clone(), ids, pages)
    assert torch.equal(out, page_scatter_ref(pool.clone(), ids, pages))


@pytest.mark.parametrize("variant", copy_kernel.VARIANTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers,kvh,d,s", [(30, 3, 64, 1), (30, 3, 64, 20), (30, 3, 64, 32),
                                            (28, 2, 128, 4095)])
def test_layered_scatter_reads_the_prefill_cache_in_place(cuda, variant, dtype, layers,
                                                          kvh, d, s):
    """The engine's install: the prefill cache's K at positions a0..a0+s (a
    strided view) into ceil(s / 16) pages, zeros past s in the last page."""
    ps, a0 = 16, 16
    cache = randn((layers, 1, a0 + s + 9, kvh, d), dtype, cuda, seed=s)
    src = gather_ops.token_rows(cache[:, 0, a0:a0 + s])
    assert src.data_ptr() == cache[:, 0, a0].data_ptr()          # read in place
    pool = gather_ops.pool_rows(randn((layers, 300, ps, kvh, d), dtype, cuda, seed=1))
    ids = page_ids(300, -(-s // ps), cuda, seed=s)
    out = run_copy("page_scatter", variant, pool.clone(), ids, src)
    assert torch.equal(out, page_scatter_ref(pool.clone(), ids, src))


def raw(t):
    """A tensor's bytes (NaN fills compare by their bits)."""
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("variant", copy_kernel.VARIANTS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int32"])
@pytest.mark.parametrize("layers", [None, 3])
def test_layered_copies_skip_out_of_range_ids(cuda, variant, dtype, layers):
    """The JAX package's contract (jnp.take / .at[].set), every row held:
    -1 wraps to page 39, -40 to page 0; a gather fills the rows of 40,
    -41 and 2**30 with jnp.take's fill (NaN, the int32 minimum); a scatter
    writes 5, 39, 7 and 0 and drops the rest."""
    lead = () if layers is None else (layers,)
    pool = randn(lead + (40, 3072), "float32", cuda, seed=2)
    pool = (pool * 1000).to(torch.int32) if dtype == "int32" else pool.to(TORCH_DTYPE[dtype])
    ids = torch.tensor([5, -1, 40, 7, 1 << 30, -40, -41], dtype=torch.int32, device=cuda)
    got = run_copy("page_gather", variant, pool, ids)
    assert torch.equal(raw(got), raw(page_gather_ref(pool, ids)))
    fill = take_fill(pool.dtype)
    for row, page in enumerate([5, 39, None, 7, None, 0, None]):
        want = (pool[..., page, :] if page is not None
                else torch.full_like(pool[..., 0, :], fill))
        assert torch.equal(raw(got[..., row, :]), raw(want)), row
    pages = randn(lead + (7, 3072), "float32", cuda, seed=3).to(pool.dtype)
    out = run_copy("page_scatter", variant, pool.clone(), ids, pages)
    assert torch.equal(raw(out), raw(page_scatter_ref(pool.clone(), ids, pages)))
    live = torch.tensor([0, 1, 3, 5], device=cuda)
    wrapped = torch.tensor([5, 39, 7, 0], dtype=torch.int32, device=cuda)
    want = page_scatter_ref(pool.clone(), wrapped, pages[..., live, :])
    assert torch.equal(raw(out), raw(want))


def test_layered_copies_with_an_unaligned_layer_stride_take_the_generic_kernel(cuda):
    """A layer stride 2 bytes past a multiple of 16: the wrapper chooses the
    generic kernel before the launch, and refuses a forced bulk one."""
    L, P, E = 3, 40, 3072
    base = randn((L * (P * E + 1),), "bfloat16", cuda, seed=4)

    def pool_of(b):
        return torch.as_strided(b, (L, P, E), (P * E + 1, E, 1))

    ids = page_ids(P, 13, cuda, seed=5)
    pages = randn((L, 13, E), "bfloat16", cuda, seed=6)
    with pytest.raises(ValueError, match="bulk variant needs"):
        copy_kernel.page_gather(pool_of(base), ids, variant="bulk")
    before = dict(copy_kernel.copy_variant_counts["page_gather"])
    got = gather_ops.page_gather(pool_of(base), ids)
    torch.cuda.synchronize()
    assert copy_kernel.copy_variant_counts["page_gather"] == {
        "bulk": before["bulk"], "generic": before["generic"] + 1}
    assert torch.equal(got, page_gather_ref(pool_of(base), ids))
    out = pool_of(base.clone())
    gather_ops.page_scatter(out, ids, pages)
    want = pool_of(base.clone())
    page_scatter_ref(want, ids, pages)
    assert torch.equal(out, want)


def test_paged_kv_cache_on_the_card_matches_the_cpu(cuda):
    """``PagedKVCache``'s installs, copy-on-write and leases on the card
    (layered bulk copies, one launch per pool) against the same op stream
    on the CPU (the plain versions): pools and leases bitwise equal."""
    from repro_torch.kvcache.paged_kv import PagedKVCache, PagedKVConfig

    cfg = PagedKVConfig(num_layers=4, num_kv_heads=2, head_dim=64, page_size=8,
                        num_pages=32, max_pages_per_seq=8, dtype="bfloat16")
    card, cpu = PagedKVCache(cfg, device=cuda), PagedKVCache(cfg, device="cpu")
    rng = np.random.default_rng(9)

    def kv(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    K.reset_launch_counts()
    copy_kernel.reset_copy_variant_counts()
    for seq, n in ((1, 13), (2, 16)):                # a short last page, whole pages
        k, v = kv(4, n, 2, 64), kv(4, n, 2, 64)
        card.add_sequence(seq, k, v)
        cpu.add_sequence(seq, k, v)
    for c in (card, cpu):
        assert c.share_prefix(1, 3, 13) == 8
        c.seq_len[3] = 6                             # the next append lands in a shared page
    k, v = kv(4, 2, 64), kv(4, 2, 64)
    card.append_token(3, k, v)
    cpu.append_token(3, k, v)
    assert card.stats()["cow_copies"] == cpu.stats()["cow_copies"] == 1
    torch.cuda.synchronize()
    assert torch.equal(card.k_pool.cpu(), cpu.k_pool) and torch.equal(card.v_pool.cpu(), cpu.v_pool)
    for layer in (None, 1):
        a, b = card.lease_kv(3, layer=layer), cpu.lease_kv(3, layer=layer)
        assert torch.equal(a.k.cpu(), b.k) and torch.equal(a.v.cpu(), b.v)
        a.release()
        b.release()
    # two installs and a copy-on-write: one scatter per pool each; one
    # gather per pool for the copy and for each lease
    assert K.launch_counts["page_scatter"] == 6 and K.launch_counts["page_gather"] == 6
    assert copy_kernel.copy_variant_counts["page_scatter"] == {"bulk": 6, "generic": 0}


def test_engine_on_the_card_goes_through_every_kernel(cuda):
    import repro_torch.models as M
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    cfg = get_smoke_config("smollm-135m")
    eng = ServeEngine(cfg, M.init_params(cfg, 0, device=cuda),
                      EngineConfig(max_batch=4, page_size=4, num_pages=64,
                                   max_pages_per_seq=16, prefill_bucket=8), device=cuda)
    prefix = np.arange(1, 11, dtype=np.int32)        # 10 tokens: not page-aligned
    eng.register_prefix(prefix)
    K.reset_launch_counts()
    reqs = [Request(rid=i, prompt=prefix.copy() if i % 2 else
                    np.concatenate([prefix, [20 + i]]).astype(np.int32), max_new_tokens=4)
            for i in range(4)]
    copy_kernel.reset_copy_variant_counts()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=200)
    assert all(r.done for r in reqs)
    assert eng.stats["cow_copies"] > 0
    assert all(n > 0 for n in K.launch_counts.values()), K.launch_counts
    # every install and copy-on-write took the bulk (TMA) copy
    for name in ("page_gather", "page_scatter"):
        assert copy_kernel.copy_variant_counts[name] == {
            "bulk": K.launch_counts[name], "generic": 0}, copy_kernel.copy_variant_counts


def flash_inputs(seed, dtype, device, b, h, kvh, sq, sk, d):
    """q/k/v as the model hands them over: [B,S,*,D] tensors viewed as
    [B,*,S,D] (strided, no copy)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(device, TORCH_DTYPE[dtype]).transpose(1, 2)
                 for s in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,nh,kvh,sq,sk,d,causal,window", [
    (1, 16, 9, 3, 32, 32, 64, True, None),          # smollm-135m prefill bucket
    (1, 16, 12, 2, 1100, 1100, 128, True, None),    # qwen2-1.5b, ragged tiles
    (2, 16, 12, 2, 300, 300, 128, True, 64),        # sliding window
    (2, 8, 8, 2, 200, 333, 128, False, None),       # Sq != Sk, ragged
    (1, 4, 4, 4, 56, 45, 64, False, 16),            # window without causality
    (2, 4, 3, 1, 40, 40, 16, True, None),           # smoke shapes: D 16, padding
    (1, 8, 6, 2, 24, 24, 8, True, None),            # qwen2 smoke: D 8
    (1, 4, 4, 2, 33, 33, 10, True, None),           # D 10: no 16-byte loads
    (1, 16, 16, 16, 1200, 1200, 64, False, None),   # seamless-m4t encoder
    (4, 16, 16, 16, 32, 1200, 64, False, None),     # seamless-m4t cross-attention
    (1, 32, 28, 4, 1536, 1536, 128, True, None),    # qwen2-vl prompt, 28 of 32 heads
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, h, nh, kvh, sq, sk, d,
                                              causal, window):
    q, k, v = flash_inputs(7, dtype, cuda, b, h, kvh, sq, sk, d)
    before = K.launch_counts["flash_attention"]
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window, num_heads=nh)
    want = flash_attention_ref(q, k, v, causal=causal, window=window, num_heads=nh)
    torch.cuda.synchronize()
    assert K.launch_counts["flash_attention"] == before + 1
    assert got.shape == q.shape and got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert max_row_rel_err(got, want) <= ROW_REL_TOL[dtype]
    assert (got[:, nh:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_rows_without_keys_give_zeros(cuda, dtype):
    """Window 16, Sq 70 > Sk 45, no causality: rows 60-69 see no key.  The
    kernel and its plain version both give zeros there (no NaN)."""
    q, k, v = flash_inputs(9, dtype, cuda, 1, 4, 4, 70, 45, 64)
    got = flash_ops.flash_attention(q, k, v, causal=False, window=16)
    want = flash_attention_ref(q, k, v, causal=False, window=16)
    assert (got[:, :, 60:] == 0).all() and (want[:, :, 60:] == 0).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert max_row_rel_err(got, want) <= ROW_REL_TOL[dtype]


def test_flash_attention_kernel_contiguous_inputs(cuda):
    q, k, v = (t.contiguous() for t in flash_inputs(8, "bfloat16", cuda, 1, 4, 2, 130, 130, 64))
    got = flash_ops.flash_attention(q, k, v)
    torch.testing.assert_close(got.float(), flash_attention_ref(q, k, v).float(),
                               **TOL["bfloat16"])


def test_engine_long_prompts_on_the_card_match_the_cpu(cuda):
    """qwen2 smoke (fp32): the engine on the card (flash_attention prefill,
    paged_attention decode) generates the CPU engine's tokens."""
    import repro_torch.models as M
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    cfg = get_smoke_config("qwen2-1.5b")
    params = M.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(150, 380, size=4)]
    out = {}
    for dev in ("cpu", cuda):
        eng = ServeEngine(cfg, params, EngineConfig(
            max_batch=2, page_size=8, num_pages=160, max_pages_per_seq=56,
            prefill_bucket=128), device=dev)
        K.reset_launch_counts()
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        eng.run_until_drained(max_steps=500)
        out[str(dev)] = [r.generated for r in sorted(eng.finished, key=lambda r: r.rid)]
    assert K.launch_counts["flash_attention"] == 4 * cfg.num_layers
    assert out["cuda"] == out["cpu"]
    assert all(r.prefill_ms > 0 for r in eng.finished) and not eng._pending_prefills


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "qwen2-vl-7b", "seamless-m4t-medium"])
def test_zoo_rest_on_the_card_matches_the_cpu(cuda, arch):
    """The rest of the zoo's smoke models (fp32): xlstm through the engine,
    tokens equal to the CPU engine's; qwen2-vl (M-RoPE positions whose
    temporal row is the index: the kernel route) and seamless
    (encoder-decoder) through prefill + decode, logits within 1e-4 of the
    CPU's, ``flash_attention`` launched on the card."""
    import repro_torch.models as M
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.interop import tree_map
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(4)
    K.reset_launch_counts()
    if arch == "xlstm-1.3b":
        prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32) for n in (3, 17, 70)]
        out = {}
        for dev in ("cpu", cuda):
            eng = ServeEngine(cfg, params, EngineConfig(
                max_batch=2, page_size=4, num_pages=64, max_pages_per_seq=24,
                prefill_bucket=8), device=dev)
            for i, p in enumerate(prompts):
                eng.submit(Request(rid=i, prompt=p, max_new_tokens=8))
            eng.run_until_drained(max_steps=500)
            out[str(dev)] = [r.generated for r in sorted(eng.finished, key=lambda r: r.rid)]
        assert out["cuda"] == out["cpu"]
        return
    b, s, sm = 2, 40, 50
    batch = {"positions": torch.arange(s, dtype=torch.int32).expand(b, 3, s).clone(),
             "embeds": torch.from_numpy(rng.standard_normal((b, s, cfg.d_model))
                                        .astype(np.float32))}
    kw = {}
    if cfg.is_encdec:
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                                            .astype(np.int32)),
                 "src_embeds": torch.from_numpy(rng.standard_normal((b, sm, cfg.d_model))
                                                .astype(np.float32))}
        kw = {"memory_len": sm}
    logits = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params)
        cache = M.init_cache(cfg, b, s + 4, device=dev, **kw)
        _, cache = M.prefill(cfg, p, {k: v.to(dev) for k, v in batch.items()}, cache)
        lg, _ = M.decode_step(cfg, p, cache, torch.tensor([3, 7], dtype=torch.int32, device=dev),
                              torch.full((b,), s, dtype=torch.int32, device=dev))
        logits[str(dev)] = lg.cpu()
    assert K.launch_counts["flash_attention"] == cfg.num_layers * (3 if cfg.is_encdec else 1)
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "hymba-1.5b"])
def test_zoo_engine_on_the_card_matches_the_cpu(cuda, arch):
    """The MoE and hybrid smoke models (fp32, windows of 8): the engine on
    the card, prompts past the window, a prefix and copy-on-write,
    generates the CPU engine's tokens; windowed decode goes through the
    kernel."""
    import repro_torch.models as M
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(2)
    prefix = rng.integers(1, cfg.vocab_size, 6).astype(np.int32)
    prompts = [prefix.copy(), np.concatenate([prefix, rng.integers(1, cfg.vocab_size, 9)])] + [
        rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32) for n in (3, 17, 30)]
    out = {}
    for dev in ("cpu", cuda):
        eng = ServeEngine(cfg, params, EngineConfig(
            max_batch=3, page_size=4, num_pages=128, max_pages_per_seq=16,
            prefill_bucket=8), device=dev)
        eng.register_prefix(prefix)
        K.reset_launch_counts()
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p.astype(np.int32), max_new_tokens=8))
        eng.run_until_drained(max_steps=500)
        out[str(dev)] = [r.generated for r in sorted(eng.finished, key=lambda r: r.rid)]
        assert eng.stats["cow_copies"] > 0 and eng.allocator.used_pages == 1 + len(
            next(iter(eng._prefixes.values())).pages)
    assert K.launch_counts["paged_attention"] > 0 and K.launch_counts["flash_attention"] > 0
    assert out["cuda"] == out["cpu"]


def check_flash(got, want, dtype, nh):
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert max_row_rel_err(got[:, :nh], want[:, :nh]) <= ROW_REL_TOL[dtype]
    assert (got[:, nh:] == 0).all()


def run_flash(q, k, v, expect_variant, **kw):
    """One call through ``ops``; asserts the variant the wrapper chose."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    before = dict(flash_kernel.variant_counts)
    got = flash_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    after = flash_kernel.variant_counts
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == expect_variant) for n in after}
    return got


@pytest.mark.parametrize("b,h,nh,kvh,sq,sk,d,causal,window", [
    (1, 16, 12, 2, 1100, 1100, 128, True, None),    # ragged tiles; rep 6 (qwen2-1.5b)
    (1, 8, 8, 2, 129, 129, 128, True, None),        # one row past a q/KV tile
    (1, 8, 8, 2, 1, 1, 128, True, None),            # a single token
    (2, 8, 8, 2, 300, 100, 128, False, None),       # Sk < Sq, non-causal, B = 2
    (1, 16, 12, 2, 700, 700, 128, True, 64),        # window inside a KV tile
    (1, 16, 12, 2, 700, 700, 128, True, 256),       # window across KV-tile edges
    (1, 4, 4, 4, 300, 300, 128, True, None),        # rep 1 (deepseek-7b)
    (1, 16, 9, 3, 300, 300, 64, True, None),        # rep 3, padded heads (smollm-135m)
    (1, 32, 32, 8, 520, 520, 128, True, None),      # rep 4 (llama3-8b)
    (2, 16, 9, 3, 1100, 900, 64, False, 256),       # D 64, window without causality
])
def test_flash_attention_hopper_variant_edges(cuda, b, h, nh, kvh, sq, sk, d, causal, window):
    """bf16 at D 64/128 with the model's strides takes the TMA/wgmma kernel
    and matches the plain version at the tile, window and grouping edges."""
    q, k, v = flash_inputs(21, "bfloat16", cuda, b, h, kvh, sq, sk, d)
    kw = dict(causal=causal, window=window, num_heads=nh)
    got = run_flash(q, k, v, "hopper", **kw)
    check_flash(got, flash_attention_ref(q, k, v, **kw), "bfloat16", nh)


def test_flash_attention_hopper_contiguous_inputs(cuda):
    q, k, v = (t.contiguous() for t in flash_inputs(22, "bfloat16", cuda, 1, 16, 2, 600, 600, 128))
    got = run_flash(q, k, v, "hopper", num_heads=12)
    check_flash(got, flash_attention_ref(q, k, v, num_heads=12), "bfloat16", 12)


@pytest.mark.parametrize("which", [0, 1])
def test_flash_attention_unaligned_view_takes_the_generic_kernel(cuda, which):
    """A q (or k) whose storage starts one element off 16 bytes cannot be
    a TMA tensor map: the generic kernel takes it, and is right."""
    args = list(flash_inputs(23, "bfloat16", cuda, 1, 16, 2, 300, 300, 128))
    t = args[which]
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
    view = flat[1:].view(t.transpose(1, 2).shape).transpose(1, 2)
    view.copy_(t)
    assert view.storage_offset() == 1 and view.data_ptr() % 16 != 0
    args[which] = view
    got = run_flash(*args, "generic", num_heads=12)
    check_flash(got, flash_attention_ref(*args, num_heads=12), "bfloat16", 12)


@pytest.mark.parametrize("variant,dtype", [("hopper", "bfloat16"), ("generic", "bfloat16"),
                                           ("generic", "float32")])
@pytest.mark.parametrize("b,h,nh,kvh,sq,sk,d,causal,window,ranks", [
    (1, 16, 12, 2, 300, 300, 128, True, None, 2),   # qwen2-1.5b over 2: rank 1 4 real + 4 padded
    (1, 32, 32, 8, 260, 260, 128, True, None, 4),   # llama3-8b over 4: whole KV groups
    (1, 16, 9, 3, 130, 130, 64, True, None, 4),     # smollm-135m over 4: rank 3 padded only
    (2, 8, 6, 2, 140, 140, 64, True, 16, 4),        # a KV group over 2 ranks, window; rank 3 padded
    (2, 8, 8, 4, 100, 170, 128, False, None, 2),    # Sq != Sk, no mask
    (4, 16, 16, 16, 120, 120, 64, False, None, 2),  # seamless's encoder over 2: no mask
    (4, 16, 16, 16, 32, 120, 64, False, None, 2),   # its cross-attention: 32 x 120, no mask
    (1, 32, 28, 4, 150, 150, 128, True, None, 2),   # qwen2-vl-7b over 2: 2 of 4 KV heads
])
def test_flash_attention_head_offset_is_the_full_launch(cuda, variant, dtype, b, h, nh, kvh,
                                                        sq, sk, d, causal, window, ranks):
    """A tensor-parallel rank's heads (``head_offset``): bitwise those heads
    of the launch over every head, and held to the plain version's heads;
    a shard of padded heads only is zeros."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    q, k, v = flash_inputs(31, dtype, cuda, b, h, kvh, sq, sk, d)
    kw = dict(causal=causal, window=window, num_heads=nh, variant=variant)
    before = dict(flash_kernel.variant_counts)
    full = flash_kernel.flash_attention(q, k, v, **kw)
    per = h // ranks
    for r in range(ranks):
        qs = q[:, r * per:(r + 1) * per]
        got = flash_kernel.flash_attention(qs, k, v, head_offset=r * per, **kw)
        want = flash_attention_ref(qs, k, v, causal=causal, window=window, num_heads=nh,
                                   head_offset=r * per)
        torch.cuda.synchronize()
        assert torch.equal(got, full[:, r * per:(r + 1) * per]), r
        real = min(max(nh - r * per, 0), per)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
        if real:
            assert max_row_rel_err(got[:, :real], want[:, :real]) <= ROW_REL_TOL[dtype]
        assert (got[:, real:] == 0).all()
    assert flash_kernel.variant_counts[variant] - before[variant] == ranks + 1


def test_flash_attention_hopper_is_deterministic(cuda):
    q, k, v = flash_inputs(24, "bfloat16", cuda, 1, 16, 2, 1100, 1100, 128)
    first = run_flash(q, k, v, "hopper", num_heads=12)
    second = run_flash(q, k, v, "hopper", num_heads=12)
    assert torch.equal(first, second)


# ------------------------------------------------------------ weight paging


@pytest.mark.parametrize("variant", copy_kernel.VARIANTS)
@pytest.mark.parametrize("name", ["page_scatter", "page_gather"])
def test_weight_path_copies_match_plain_bitwise(cuda, variant, name):
    """qwen2-1.5b's weight path: a [376, 1,048,576] bf16 pool of 2 MiB pages
    (8 layers of 47), one layer's 47 pages installed or gathered."""
    P, E, n = 376, 1 << 20, 47
    pool = randn((P, E), "bfloat16", cuda, seed=11)
    ids = page_ids(P, n, cuda, seed=12)
    if name == "page_gather":
        got = run_copy(name, variant, pool, ids)
        assert torch.equal(got, page_gather_ref(pool, ids))
    else:
        pages = randn((n, E), "bfloat16", cuda, seed=13)
        got = run_copy(name, variant, pool.clone(), ids, pages)
        assert torch.equal(got, page_scatter_ref(pool.clone(), ids, pages))


def test_copy_h2d_copies_read_only_host_pages(cuda):
    host = np.random.default_rng(14).integers(0, 255, size=3 << 20, dtype=np.uint8)
    view = host[1 << 20:]
    view.flags.writeable = False
    dst = torch.zeros(4 << 20, dtype=torch.uint8, device=cuda)
    copy_kernel.copy_h2d(dst, view.ctypes.data, view.nbytes)
    torch.cuda.synchronize()
    assert torch.equal(dst[:view.nbytes].cpu(), torch.from_numpy(host[1 << 20:].copy()))
    assert (dst[view.nbytes:] == 0).all()
    with pytest.raises(ValueError, match="do not fit"):
        copy_kernel.copy_h2d(dst, view.ctypes.data, dst.numel() + 1)


def packed_layers(seed, page):
    """Three bf16 layers (uint16 bit patterns, as the port hands bf16 to
    numpy) of 4, 2 and 4 pages, packed into one image."""
    from repro_torch.serve.weight_pager import pack_layer_arrays

    rng = np.random.default_rng(seed)
    half = page // 2
    layers = [rng.integers(0, 1 << 16, size=n, dtype=np.uint16)
              for n in (4 * half - 3, 2 * half, 4 * half)]
    buf, specs = pack_layer_arrays(layers, page)
    return layers, buf, specs


def region_of(buf, page, **cfg):
    from repro_torch.core import HostArrayStore, UMapConfig, umap

    return umap(HostArrayStore(buf.copy()),
                config=UMapConfig(page_size=page, buffer_size=buf.nbytes, max_lease_run=8,
                                  **cfg))


@pytest.mark.parametrize("zero_copy", [True, False])
def test_region_layer_source_on_the_card_matches_the_cpu(cuda, zero_copy):
    """The same packed store read through a card source and a CPU source:
    bitwise equal layers, equal leases, no host staging on the lease path,
    and one bulk scatter per install and one bulk gather per read."""
    import warnings

    from repro_torch.core import uunmap
    from repro_torch.serve.weight_pager import RegionLayerSource

    page = 64 * 1024
    layers, buf, specs = packed_layers(15, page)
    regs = [region_of(buf, page, zero_copy_leases=zero_copy) for _ in range(2)]
    try:
        card = RegionLayerSource(regs[0], specs, device=cuda, pool_pages=4, dtype=torch.bfloat16)
        cpu = RegionLayerSource(regs[1], specs, device="cpu", pool_pages=4, dtype=torch.bfloat16)
        K.reset_launch_counts()
        copy_kernel.reset_copy_variant_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("error")          # no read-only-array warning
            for _ in range(2):
                for i in (0, 1, 2, 1):
                    got = card[i]
                    # random bit patterns hold NaNs: compare bits
                    assert got.is_cuda and torch.equal(raw(got.cpu()), raw(cpu[i]))
                    assert np.array_equal(got.cpu().view(torch.int16).numpy().view(np.uint16),
                                          layers[i].reshape(got.shape))
        assert regs[0].stats()["leases"] == regs[1].stats()["leases"]
        # a pool of 4 pages holds one layer: each of the 8 reads installs
        # (4 + 2 + 4 + 2 pages a sweep) and gathers once
        assert card.staging_copies == cpu.staging_copies == (0 if zero_copy else 24)
        assert copy_kernel.copy_variant_counts == {
            "page_gather": {"bulk": 8, "generic": 0}, "page_scatter": {"bulk": 8, "generic": 0}}
    finally:
        for r in regs:
            uunmap(r)


class TestGatherCompletesUnderLock:
    """Port of ``tests/test_train_ooc.py``'s ``TestGatherCompletesUnderLock``
    across CUDA streams.  ``page_scatter`` installs into the pool in place,
    from whichever filler's stream fetched the layer; a gather still running
    when another stream scatters into the same slots would read torn pages.
    Every gather (and install) of the pool completes before the source's
    lock is released; this pins that contract with 512 KiB pages, and with
    two fillers on their own streams installing into the same slots."""

    PAGE = 512 * 1024

    def tree(self):
        """fp32 leaves of 4, 2 and 4 pages, as the reference's."""
        rng = np.random.default_rng(5)
        return [rng.standard_normal(n).astype(np.float32)
                for n in (self.PAGE, self.PAGE // 2, self.PAGE)]

    def source(self, leaves, cuda, pool_pages=None):
        from repro_torch.serve.weight_pager import RegionLayerSource, pack_layer_arrays

        buf, specs = pack_layer_arrays(leaves, self.PAGE)
        region = region_of(buf, self.PAGE)
        return region, RegionLayerSource(region, specs, device=cuda, pool_pages=pool_pages)

    def test_gather_result_ready_on_return(self, cuda, monkeypatch):
        import repro_torch.serve.weight_pager as wp
        from repro_torch.core import uunmap

        leaves = self.tree()
        region, src = self.source(leaves, cuda)
        gathered = []
        orig = wp.page_gather

        def capture(pool, ids, **kw):
            out = orig(pool, ids, **kw)
            ev = torch.cuda.Event()
            ev.record()
            gathered.append(ev)
            return out

        monkeypatch.setattr(wp, "page_gather", capture)
        try:
            for _ in range(2):                     # fetch-install pass + cached pass
                for i, leaf in enumerate(leaves):
                    got = src[i]
                    assert gathered[-1].query(), \
                        "pool gather must complete before __getitem__ returns"
                    np.testing.assert_array_equal(got.cpu().numpy(), leaf)
                src.invalidate()
            assert len(gathered) == 2 * len(leaves)
        finally:
            uunmap(region)

    def test_two_fillers_on_their_own_streams_share_one_layer_of_slots(self, cuda):
        """A pool of one layer (4 pages): every install evicts the layer
        before it into the same slots.  Two weight-pager fillers, each on its
        own stream, and two more reader threads on their own streams keep
        installing and gathering; every layer comes back whole."""
        import threading

        from repro_torch.core import uunmap
        from repro_torch.serve.weight_pager import LayerWeightPager

        leaves = self.tree()
        region, src = self.source(leaves, cuda, pool_pages=4)
        bad = []

        def reader(seed):
            rng = np.random.default_rng(seed)
            with torch.cuda.stream(torch.cuda.Stream()):
                for i in rng.integers(0, len(leaves), size=12):
                    if not np.array_equal(src[int(i)].cpu().numpy(), leaves[i]):
                        bad.append(int(i))

        try:
            pager = LayerWeightPager(src, num_slots=2, readahead=1, device=cuda, num_fillers=2)
            threads = [threading.Thread(target=reader, args=(s,)) for s in range(2)]
            try:
                for t in threads:
                    t.start()
                want = sum(np.pad(a, (0, self.PAGE - a.size)) for a in leaves)
                for _ in range(3):
                    x = pager.run(torch.zeros(self.PAGE, device=cuda), lambda p, x, i: x + (
                        torch.nn.functional.pad(p, (0, x.numel() - p.numel()))))
                    np.testing.assert_array_equal(x.cpu().numpy(), want)
            finally:
                for t in threads:
                    t.join(timeout=60)
                pager.close()
            assert not any(t.is_alive() for t in threads) and bad == []
            assert pager.stats["fills"] >= len(leaves)
        finally:
            uunmap(region)


# ------------------------------------------------------------------ training


def grad_row_rel_err(got, want):
    """(largest ||got - want|| over a row divided by the larger of the row's
    ||want|| and the median row norm, ||got - want|| / ||want|| over the
    tensor).  A bf16 gradient row can be small by cancellation; see
    ``chip_smoke.py``'s TRAIN_GRAD_ROW_TOL."""
    diff = (got.float() - want.float()).norm(dim=-1).flatten()
    norm = want.float().norm(dim=-1).flatten()
    return ((diff / norm.clamp(min=norm.median().item())).max().item(),
            (diff.norm() / norm.norm()).item())


TRAIN_GRAD_ROW_TOL = dict(float32=2e-5, bfloat16=1e-1)
TRAIN_GRAD_TENSOR_TOL = dict(float32=2e-5, bfloat16=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_vjp_attention_matches_dense_autograd(cuda, dtype):
    """The training attention's output and dq, dk, dv at a ragged length
    (1100 = 2 chunks of 512 + 76) against autograd through the dense route."""
    from repro_torch.models.layers import AttnSpec, FlashVJPAttention, _dense_attention

    rng = np.random.default_rng(0)
    b, s, h, d = 2, 1100, 16, 64
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
                   .to(cuda, TORCH_DTYPE[dtype]).requires_grad_(True) for _ in range(4))
    do = do.detach()
    pos = torch.arange(s, dtype=torch.int32, device=cuda).expand(b, s)
    spec = AttnSpec(causal=True, impl="chunked", chunk_size=512)
    o = FlashVJPAttention.apply(q, k, v, pos, pos, None, spec)
    got = (o, *torch.autograd.grad(o, (q, k, v), do))
    o = _dense_attention(q, k, v, spec, pos, pos, None)
    want = (o, *torch.autograd.grad(o, (q, k, v), do))
    assert max_row_rel_err(got[0], want[0]) <= ROW_REL_TOL[dtype]
    for g, w in zip(got[1:], want[1:]):
        row, tensor = grad_row_rel_err(g, w)
        assert row <= TRAIN_GRAD_ROW_TOL[dtype] and tensor <= TRAIN_GRAD_TENSOR_TOL[dtype]


def test_adamw_elementwise_is_chunk_invariant_on_the_card(cuda):
    from repro_torch.train.optimizer import AdamWConfig, adamw_elementwise, update_scalars

    rng = np.random.default_rng(1)
    n = 3 * 262144 + 1001
    p, g, m = (torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
               for _ in range(3))
    v = torch.from_numpy(np.abs(rng.standard_normal(n)).astype(np.float32) * 1e-3).to(cuda)
    cfg = AdamWConfig(warmup_steps=10)
    scalars = update_scalars(cfg, torch.tensor(3, dtype=torch.int32, device=cuda),
                             torch.tensor(2.5, device=cuda))
    whole = adamw_elementwise(cfg, p, g, m, v, *scalars)
    bounds = [0, 1, 262144, 262145, 2 * 262144 + 7, n]
    parts = [adamw_elementwise(cfg, *(t[lo:hi] for t in (p, g, m, v)), *scalars)
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    for i, w in enumerate(whole):
        assert torch.equal(torch.cat([part[i] for part in parts]), w)


def test_ooc_trainer_paged_is_bitwise_resident_on_the_card(cuda):
    """The tiny model of tests/test_train_ooc.py, 3 steps at 2x
    oversubscription: paged (leaves through the page copies) and resident
    state bitwise equal, every copy one bulk launch per leaf."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.interop import tree_flatten
    from repro_torch.train.ooc import OOCTrainer, OOCTrainerConfig
    from repro_torch.train.train_step import TrainConfig

    cfg = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256)
    rng = np.random.default_rng(0)
    batches = [{k: rng.integers(0, 256, (2, 16)).astype(np.int32) for k in ("tokens", "labels")}
               for _ in range(3)]
    out = {}
    for paged in (False, True):
        kw = dict(params_buffer_pages=81, moments_buffer_pages=162) if paged else {}
        tr = OOCTrainer(cfg, TrainConfig(), OOCTrainerConfig(page_size=4096, **kw),
                        paged=paged, device=cuda)
        try:
            K.reset_launch_counts()
            copy_kernel.reset_copy_variant_counts()
            losses = [tr.step(b)["loss"] for b in batches]
            out[paged] = (losses, tr.state_dict(), dict(K.launch_counts),
                          {n: dict(c) for n, c in copy_kernel.copy_variant_counts.items()},
                          tr.staging_copies, len(tr.source) if paged else 0)
        finally:
            tr.close()
    (rl, rs, _, _, _, _), (pl, pstate, launches, variants, staging, leaves) = out[False], out[True]
    assert pl == rl and staging == 0
    for a, b in zip(tree_flatten(pstate)[0], tree_flatten(rs)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for name in ("page_scatter", "page_gather"):
        assert launches[name] == 3 * leaves
        assert variants[name] == {"bulk": 3 * leaves, "generic": 0}


def test_trainer_step_remat_full_is_bitwise_remat_none(cuda):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.interop import tree_flatten
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_smoke_config("smollm-135m").replace(compute_dtype="bfloat16")
    rng = np.random.default_rng(2)
    t = rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()}
    states = []
    for remat in ("none", "full"):
        tr = Trainer(cfg.replace(remat=remat), TrainerConfig(total_steps=1, log_every=1),
                     device=cuda)
        tr.fit([batch])
        states.append((tr.metrics_log[0]["loss"], tree_flatten(tr.state())[0]))
    assert states[0][0] == states[1][0]
    for a, b in zip(states[0][1], states[1][1]):
        assert a == b if isinstance(a, int) else torch.equal(a, b)


# ---------------------------------------------------- distribution (NCCL)


@pytest.fixture(scope="module")
def nccl(tmp_path_factory):
    """A 1-rank NCCL group (file store) and a (1, 1) ("data", "model")
    DeviceMesh on the card; NCCL refuses two ranks on one card, so the
    multi-rank semantics are the gloo tests' (test_torch_distributed_ranks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (NCCL)")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import init_process_group

    torch.cuda.set_device(0)
    init_process_group("cuda", f"file://{tmp_path_factory.mktemp('nccl') / 'store'}")
    try:
        assert dist.get_backend() == "nccl"
        yield init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_nccl_train_cell_is_bitwise_train_step(cuda, nccl):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.interop import tree_flatten, tree_map
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import TrainConfig, train_step

    cfg = get_smoke_config("smollm-135m").replace(compute_dtype="bfloat16")
    tcfg = TrainConfig(optimizer=AdamWConfig(warmup_steps=1), loss_chunk=16)
    with use_mesh(nccl, rules_for("train", cfg)):
        cell = SP.build_cell(cfg, ShapeConfig("t", 32, 2, "train"), nccl, tcfg)
    params = init_params(cfg, seed=0, device=cuda)
    ref_p, ref_s = params, init_state(params)
    p, s = tree_map(torch.clone, params), SP.local_tree(init_state(params), cell.in_specs[1], nccl)
    rng = np.random.default_rng(0)
    for _ in range(2):
        t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)).to(cuda)
        batch = {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}
        ref_p, ref_s, rm = train_step(cfg, tcfg, ref_p, ref_s, batch)
        p, s, m = cell.fn(p, s, SP.local_tree(batch, cell.in_specs[2], nccl))
        assert torch.equal(m["loss"], rm["loss"])
        for a, b in zip(tree_flatten((p, s.m, s.v))[0], tree_flatten((ref_p, ref_s.m, ref_s.v))[0]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["tp", "ep"])
def test_nccl_moe_shard_local_matches_dense(cuda, nccl, kind):
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models.common import init_param_tree
    from repro_torch.models.moe import _moe_forward_dense, moe_forward, moe_param_specs

    gen = torch.Generator().manual_seed(0)
    p = init_param_tree(moe_param_specs(64, 128, 8, kind), gen, torch.float32, cuda)
    x = torch.randn(4, 32, 64, generator=gen).to(cuda)
    y_ref, aux_ref = _moe_forward_dense(p, x, 2, 1.0)
    with use_mesh(nccl):
        y, aux = moe_forward(p, x, 2, 1.0, shard_local=True, moe_sharding=kind)
    torch.testing.assert_close(y, y_ref, **TOL["float32"])
    for k in aux_ref:
        torch.testing.assert_close(aux[k], aux_ref[k], **TOL["float32"])


def test_nccl_elastic_restore_onto_cuda_dtensors(cuda, nccl):
    from repro_torch.ckpt.checkpoint import save_tree_to_store
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import HostArrayStore
    from repro_torch.distributed.elastic import restore_train_state_elastic
    from repro_torch.interop import to_numpy, tree_flatten, tree_map
    from repro_torch.models.transformer import init_params

    cfg = get_smoke_config("smollm-135m")
    params = tree_map(to_numpy, init_params(cfg, seed=0, device="cpu"))
    state = {"params": params, "opt": {"m": params, "v": params}, "step": 3}
    nbytes = sum(np.asarray(a).nbytes for a in tree_flatten(state)[0])
    store = HostArrayStore(np.zeros(nbytes + 4096, np.uint8))
    manifest = save_tree_to_store(store, state)
    store.reset_stats()
    like = tree_map(lambda a: np.zeros_like(np.asarray(a)), state)
    restored, report = restore_train_state_elastic(cfg, nccl, store, manifest, like)
    assert store.num_reads == 1 and report.devices == 1
    for tree in (restored["params"], restored["opt"]["m"], restored["opt"]["v"]):
        for a, b in zip(tree_flatten(tree)[0], tree_flatten(params)[0]):
            assert a.to_local().device.type == "cuda"
            np.testing.assert_array_equal(to_numpy(a.to_local()), b)


def test_nccl_compressed_all_reduce_is_the_dequantized_value(cuda, nccl):
    from repro_torch.distributed.collectives import compressed_all_reduce, quantize_int8

    x = torch.randn(300, 70, generator=torch.Generator().manual_seed(1)).to(cuda)
    err = torch.zeros_like(x)
    mean, new_err = compressed_all_reduce(x, nccl.get_group("data"), err)
    q, scale, want_err = quantize_int8(x, err)
    assert torch.equal(mean, q.float() * scale) and torch.equal(new_err, want_err)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama3-8b"])
def test_nccl_prefill_and_decode_cells_are_bitwise_the_model(cuda, nccl, arch):
    """The tensor-parallel code path at world size 1: the prefill cell's
    logits and cache and two decode-cell steps bitwise ``T.prefill`` /
    ``T.decode_step`` (bf16 compute, the prefill on the kernel)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.interop import tree_flatten
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import transformer as T

    cfg = get_smoke_config(arch).replace(compute_dtype="bfloat16")
    params = T.init_params(cfg, seed=0, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)).to(cuda)
    cells = {}
    for kind in ("prefill", "decode"):
        with use_mesh(nccl, rules_for(kind, cfg)):
            cells[kind] = SP.build_cell(cfg, ShapeConfig(kind, 32, 2, kind), nccl)
    logits, cache = cells["prefill"].fn(params, {"tokens": tokens})
    want_cache = T.init_cache(cfg, 2, 32, device=cuda)
    hidden, want_cache = T.prefill(cfg, params, {"tokens": tokens}, want_cache)
    assert torch.equal(logits, T.lm_logits(cfg, params, hidden))
    for a, b in zip(tree_flatten(cache)[0], tree_flatten(want_cache)[0]):
        assert torch.equal(a, b)
    want_logits = logits
    for step in range(2):
        nxt = want_logits.argmax(-1).to(torch.int32)
        cur = torch.full_like(nxt, 24 + step)
        logits, cache = cells["decode"].fn(params, cache, nxt, cur)
        want_logits, want_cache = T.decode_step(cfg, params, want_cache, nxt, cur)
        assert torch.equal(logits, want_logits)
