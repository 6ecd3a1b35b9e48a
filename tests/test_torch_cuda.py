"""PyTorch port on the card: each CUDA kernel against its plain version.

Every test here is marked ``cuda`` and skips where ``torch.cuda`` finds no
card (the kernels have no CPU mode).  This file imports neither JAX nor the
JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances are the JAX package's kernel-test ones (fp32 2e-5, bf16 3e-2);
page copies are bitwise.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels.page_gather import ops as gather_ops
from repro_torch.kernels.paged_attention import ops as attn_ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

TOL = dict(float32=dict(atol=2e-5, rtol=2e-5),
           bfloat16=dict(atol=3e-2, rtol=3e-2))
TORCH_DTYPE = dict(float32=torch.float32, bfloat16=torch.bfloat16)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
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
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_paged_attention_kernel_length_zero_and_long_context(cuda):
    args = attention_inputs(6, "float32", cuda, 4, 6, 2, 64, 600, 16, 128,
                            lengths=[2048, 0, 1, 1777])
    got = attn_ops.paged_attention(*args)
    torch.testing.assert_close(got, paged_attention_ref(*args), **TOL["float32"])
    assert (got[1] == 0).all()


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
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=200)
    assert all(r.done for r in reqs)
    assert eng.stats["cow_copies"] > 0
    assert all(n > 0 for n in K.launch_counts.values()), K.launch_counts
