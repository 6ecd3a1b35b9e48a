"""PyTorch port: smollm smoke model against the JAX package, fp32.

The JAX package's seeded weights go to the port through
``params_from_numpy``; tokens come from a numpy seed.  ``prefill`` and
``decode_step`` logits must agree within 1e-4, greedy tokens must be
identical over 16 steps, and the port's paged decode (in-place token write
+ ``paged_attention``) must match the JAX package's paged decode (gather
pages + plain ``decode_attention``).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as RM
import repro_torch.models as M
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro_torch.configs.registry import get_smoke_config
from repro_torch.interop import params_from_numpy, tree_map
from repro_torch.models.blocks import _gather_paged, _write_paged_cache
from repro_torch.models.layers import attention, AttnSpec, decode_attention, expand_kv, make_qh_to_kv_map

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def model():
    ref_cfg = ref_smoke_config("smollm-135m")
    ref_params = RM.init_params(ref_cfg, jax.random.key(0))
    cfg = get_smoke_config("smollm-135m")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params),
                               device="cpu", cfg=cfg)
    return ref_cfg, ref_params, cfg, params


def test_prefill_and_greedy_decode_match_reference(model):
    ref_cfg, ref_params, cfg, params = model
    rng = np.random.default_rng(0)
    B, S, steps = 2, 7, 16
    prompt = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)

    rc = RM.init_cache(ref_cfg, B, S + steps + 4)
    rh, rc = RM.prefill(ref_cfg, ref_params, {"tokens": jnp.asarray(prompt)}, rc)
    tc = M.init_cache(cfg, B, S + steps + 4, device="cpu")
    th, tc = M.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)}, tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), **TOL)
    np.testing.assert_allclose(tc[0]["k"].numpy(), np.asarray(rc[0]["k"]), **TOL)
    np.testing.assert_array_equal(tc[0]["pos"].numpy(), np.asarray(rc[0]["pos"]))

    ref_decode = jax.jit(partial(RM.decode_step, ref_cfg))
    rtok = ttok = rng.integers(1, cfg.vocab_size, size=B).astype(np.int32)
    cur = np.full(B, S, np.int32)
    rgen, tgen = [], []
    for _ in range(steps):
        rl, rc = ref_decode(ref_params, rc, jnp.asarray(rtok), jnp.asarray(cur))
        tl, tc = M.decode_step(cfg, params, tc, torch.from_numpy(ttok), torch.from_numpy(cur))
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
        rtok = np.asarray(jnp.argmax(rl, axis=-1)).astype(np.int32)
        ttok = tl.argmax(dim=-1).numpy().astype(np.int32)
        rgen.append(rtok.tolist())
        tgen.append(ttok.tolist())
        cur = cur + 1
    assert tgen == rgen


def paged_caches(cfg, rng, B, P, ps, maxp, lens):
    """Engine-shaped paged caches, random pool contents, distinct pages."""
    n = cfg.num_layers
    pools = rng.standard_normal((2, n, P, ps, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    table = np.zeros((B, maxp), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b in range(B):
        table[b] = perm[b * maxp:(b + 1) * maxp]
    lens = np.asarray(lens, np.int32)
    return pools, np.broadcast_to(table, (n, B, maxp)), np.broadcast_to(lens, (n, B))


def test_paged_decode_kernel_path_matches_reference_gather_path(model):
    ref_cfg, ref_params, cfg, params = model
    rng = np.random.default_rng(1)
    B, P, ps, maxp = 3, 40, 4, 6
    pools, table, lens = paged_caches(cfg, rng, B, P, ps, maxp, [1, 9, 16])
    rcache = [{"k_pool": jnp.asarray(pools[0]), "v_pool": jnp.asarray(pools[1]),
               "table": jnp.asarray(table), "len": jnp.asarray(lens)}]
    tcache = [{"k_pool": torch.from_numpy(pools[0].copy()),
               "v_pool": torch.from_numpy(pools[1].copy()),
               "table": torch.from_numpy(table[0].copy()).expand(table.shape),
               "len": torch.from_numpy(lens[0].copy()).expand(lens.shape)}]
    ref_decode = jax.jit(partial(RM.decode_step, ref_cfg))
    tok = rng.integers(1, cfg.vocab_size, size=B).astype(np.int32)
    for _ in range(3):
        cur = np.asarray(rcache[0]["len"][0])
        rl, rcache = ref_decode(ref_params, rcache, jnp.asarray(tok), jnp.asarray(cur))
        tl, tcache = M.decode_step(cfg, params, tcache, torch.from_numpy(tok),
                                   torch.from_numpy(cur.copy()))
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
        np.testing.assert_array_equal(tcache[0]["len"].numpy(), np.asarray(rcache[0]["len"]))
        tok = tl.argmax(dim=-1).numpy().astype(np.int32)
    np.testing.assert_allclose(tcache[0]["k_pool"].numpy(), np.asarray(rcache[0]["k_pool"]), **TOL)
    np.testing.assert_allclose(tcache[0]["v_pool"].numpy(), np.asarray(rcache[0]["v_pool"]), **TOL)


def test_paged_attention_path_equals_gather_oracle_with_padded_heads(model):
    """Inside the port: the kernel path (padded heads as zeros) equals the
    gather oracle (padded heads expanded onto KV head 0), after wo."""
    _, _, cfg, params = model
    from repro_torch.kernels.paged_attention.ops import paged_attention

    rng = np.random.default_rng(2)
    B, P, ps, maxp = 3, 30, 4, 5
    pools, table, lens = paged_caches(cfg, rng, B, P, ps, maxp, [3, 11, 20])
    cache = {"k_pool": torch.from_numpy(pools[0, 0].copy()),
             "v_pool": torch.from_numpy(pools[1, 0].copy()),
             "table": torch.from_numpy(table[0].copy()), "len": torch.from_numpy(lens[0].copy())}
    q = torch.from_numpy(rng.standard_normal((B, 1, cfg.padded_heads, cfg.head_dim)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((B, 1, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32))
    new = _write_paged_cache(cache, kv, kv)
    o_kernel = paged_attention(q[:, 0].contiguous(), new["k_pool"], new["v_pool"], new["table"],
                               new["len"], num_heads=cfg.num_heads)
    kc, vc, kpos, cur = _gather_paged(new)
    qh = make_qh_to_kv_map(cfg.num_heads, cfg.num_kv_heads, cfg.padded_heads)
    o_gather = decode_attention(q, expand_kv(kc, qh), expand_kv(vc, qh), kpos, cur)
    wo = params["segments"][0]["attn"]["wo"][0]
    torch.testing.assert_close(o_kernel[:, :cfg.num_heads], o_gather[:, 0, :cfg.num_heads],
                               atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(o_kernel.reshape(B, -1) @ wo, o_gather.reshape(B, -1) @ wo,
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal_skip", [False, True])
def test_chunked_attention_matches_dense(causal_skip):
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 32, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 32, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 32, 2, 16)).astype(np.float32))
    pos = torch.arange(32, dtype=torch.int32).expand(2, 32)
    for window in (None, 8):
        dense = attention(q, k, v, AttnSpec(window=window, impl="dense"), pos, pos)
        chunked = attention(q, k, v, AttnSpec(window=window, impl="chunked", chunk_size=8,
                                              causal_skip=causal_skip), pos, pos)
        torch.testing.assert_close(chunked, dense, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama3-8b", "deepseek-7b"])
def test_dense_smoke_configs_match_reference(arch):
    """The other dense configs of the port's registry (QKV bias and 6 of 8
    padded heads over 2 KV heads; GQA 8 over 2; MHA with an untied head):
    prefill (the flash_attention route) and greedy decode steps against the
    JAX package, fp32 logits within 1e-4, tokens identical.  qwen2 decodes
    16 tokens; llama3 and deepseek share its block kind and decode 4."""
    ref_cfg = ref_smoke_config(arch)
    cfg = get_smoke_config(arch)
    # the port's seeded weights feed both (the same tree: keys, shapes, dtypes)
    params = M.init_params(cfg, seed=1, device="cpu")
    ref_params = tree_map(lambda t: jnp.asarray(t.numpy()), params)
    rng = np.random.default_rng(4)
    B, S, steps = 2, 11, 16 if arch == "qwen2-1.5b" else 4
    prompt = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    rc = RM.init_cache(ref_cfg, B, S + steps + 1)
    rh, rc = jax.jit(RM.prefill, static_argnums=0)(
        ref_cfg, ref_params, {"tokens": jnp.asarray(prompt)}, rc)
    tc = M.init_cache(cfg, B, S + steps + 1, device="cpu")
    th, tc = M.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)}, tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), **TOL)
    np.testing.assert_allclose(tc[0]["v"].numpy(), np.asarray(rc[0]["v"]), **TOL)

    ref_decode = jax.jit(partial(RM.decode_step, ref_cfg))
    tok = prompt[:, -1].copy()
    cur = np.full(B, S, np.int32)
    rtok, ttok = tok, tok
    for _ in range(steps):
        rl, rc = ref_decode(ref_params, rc, jnp.asarray(rtok), jnp.asarray(cur))
        tl, tc = M.decode_step(cfg, params, tc, torch.from_numpy(ttok), torch.from_numpy(cur))
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
        rtok = np.asarray(jnp.argmax(rl, axis=-1)).astype(np.int32)
        ttok = tl.argmax(dim=-1).numpy().astype(np.int32)
        np.testing.assert_array_equal(ttok, rtok)
        cur = cur + 1


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-1.5b"])
def test_flash_prefill_route_equals_explicit_positions_route(arch):
    """Inside the port: a prefill without positions (flash_attention, padded
    heads as zeros, un-expanded KV) equals one given positions 0..S-1 (plain
    dense attention over expanded KV), hidden state and cache."""
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, seed=2, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(2, 37)).astype(np.int32))
    pos = torch.arange(37, dtype=torch.int32).expand(2, 37)
    h_flash, c_flash = M.prefill(cfg, params, {"tokens": tokens},
                                 M.init_cache(cfg, 2, 40, device="cpu"))
    h_plain, c_plain = M.prefill(cfg, params, {"tokens": tokens, "positions": pos},
                                 M.init_cache(cfg, 2, 40, device="cpu"))
    torch.testing.assert_close(h_flash, h_plain, atol=2e-5, rtol=2e-5)
    # layer 0's KV precedes any attention: bitwise; later layers within fp32
    for key in ("k", "v"):
        torch.testing.assert_close(c_flash[0][key][0], c_plain[0][key][0], atol=0, rtol=0)
        torch.testing.assert_close(c_flash[0][key], c_plain[0][key], atol=2e-5, rtol=2e-5)
