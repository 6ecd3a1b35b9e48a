"""The frozen cost formulas against the port's meta formulas, where both
count the same keys (whole tables, no window), and the model FLOPs."""

import json
from pathlib import Path

import pytest
import torch

import cb_support  # noqa: F401
from cellbench import costs
from repro_torch.kernels import meta

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.mark.parametrize("b,h,kvh,sq,d,causal,nh,off", [
    (1, 32, 32, 2496, 128, True, None, 0), (1, 32, 8, 3584, 128, True, None, 0),
    (2, 8, 2, 300, 64, False, 6, 2), (3, 16, 4, 77, 128, True, 16, 0)])
def test_flash_equals_meta(b, h, kvh, sq, d, causal, nh, off):
    q = torch.empty((b, h, sq, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, kvh, sq, d), dtype=torch.bfloat16, device="meta")
    want = meta.flash_attention_cost(q, k, causal, None, nh, off)
    assert costs.flash_attention_cost(b, h, sq, d, kvh, sq, 2, causal, None, nh, off) == want


@pytest.mark.parametrize("b,h,kvh,d,ps,pps", [(64, 32, 32, 128, 16, 257), (48, 32, 8, 128, 16, 257),
                                              (5, 8, 2, 64, 4, 9)])
def test_paged_equals_meta_on_full_tables(b, h, kvh, d, ps, pps):
    q = torch.empty((b, h, d), dtype=torch.bfloat16, device="meta")
    pool = torch.empty((100, ps, kvh, d), dtype=torch.bfloat16, device="meta")
    table = torch.empty((b, pps), dtype=torch.int32, device="meta")
    want = meta.paged_attention_cost(q, pool, table)
    assert costs.paged_attention_cost([pps * ps] * b, h, d, kvh, ps, 2) == want


def test_paged_counts_real_lengths_and_window():
    f, nb = costs.paged_attention_cost([1, 17, 100], 4, 8, 2, 16, 2, window=50)
    assert f == 4 * 4 * 8 * (1 + 17 + 50)
    assert nb == (3 * 4 * 8 + 2 * 68 * 2 * 8 + 3 * 4 * 8) * 2 + (1 + 2 + 7) * 4 + 12


def test_visible_keys_brute_force():
    for sq, sk, causal, w in [(10, 10, True, None), (9, 12, True, 4), (7, 7, False, 3)]:
        n = sum(1 for qi in range(sq) for ki in range(sk)
                if (not causal or ki <= qi) and (w is None or qi - ki < w))
        assert costs.visible_keys(sq, sk, causal, w) == n


def test_model_flops_per_token():
    ds = costs.ModelFlops(json.loads((CONFIGS / "deepseek-7b.json").read_text()))
    # 6.48e9 parameters in the 30 blocks: 2 FLOPs each a token
    assert ds.per_token_layers == 2 * 30 * (4 * 4096 * 4096 + 3 * 4096 * 11008)
    mx = costs.ModelFlops(json.loads((CONFIGS / "mixtral-8x7b-16l.json").read_text()))
    routed = 4096 * 8 + 2 * 3 * 4096 * 14336
    assert mx.per_token_layers == 2 * 16 * (2 * 4096 * 4096 + 2 * 4096 * 1024 + routed)
    # prefill of positions [a, b) + decode of b equals the pairs of [0, b + 1)
    assert ds.prefill(0, 10) - ds.prefill(0, 4) == 6 * ds.per_token_layers + \
        30 * ds.attn_pair * sum(range(5, 11))
    assert ds.decode([9]) == ds.per_token_layers + ds.head + 30 * ds.attn_pair * 10
