"""PyTorch port: M-RoPE with embedding inputs (qwen2-vl) and the
encoder-decoder (seamless-m4t) against the JAX package, fp32, on the CPU.

The same numpy inputs go to both, the port's seeded weights handed to the
JAX package through numpy:

* ``apply_rope`` under M-RoPE, with positions whose three rows differ, and
  the GELU MLP: 2e-5 (``tests/test_kernels.py``);
* qwen2vl-smoke and seamless-smoke: ``forward_train``, ``prefill`` and a
  greedy ``decode_step`` chain within 1e-4 (the model parity of
  ``test_torch_models.py``), tokens equal;
* ``tests/test_extras.py``'s two checks run on the port: the embeddings
  prefill then token decode, and the encoder-decoder's decode through the
  cached memory KV against the full forward (rtol 2e-3 / atol 2e-4);
* the route of a prefill: the ``flash_attention`` kernel only where the
  temporal row of the positions is ``0..S-1`` in every row, the plain
  attention otherwise, each equal to the other where both apply;
* a prompt with an image block (temporal position constant over the block):
  the port's first decode step equals the full forward over the prompt and
  the token.  The JAX package indexes its cache by temporal position, so
  the block's tokens overwrite each other there (ROADMAP.md, divergences
  of the reference).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as RM
import repro_torch.models as M
import repro_torch.models.transformer as T
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.models import layers as rl
from repro_torch.configs.registry import get_smoke_config
from repro_torch.interop import tree_map
from repro_torch.models import layers

TOL = dict(atol=2e-5, rtol=2e-5)
MTOL = dict(atol=1e-4, rtol=1e-4)
VLM, ENCDEC = "qwen2-vl-7b", "seamless-m4t-medium"


def mrope_positions(b, s, seed):
    """Temporal row 0..s-1; height and width rows that differ from it."""
    rng = np.random.default_rng(seed)
    pos = np.empty((b, 3, s), np.int32)
    pos[:, 0] = np.arange(s)
    pos[:, 1:] = rng.integers(0, s, size=(b, 2, s))
    return pos


def image_block_positions(text, grid):
    """Qwen2-VL's position rule for ``text`` tokens, a ``grid`` x ``grid``
    image block, then ``text`` tokens: the block keeps one temporal
    position and spans the grid in height and width; the text after it
    continues past the block's largest position."""
    t0 = text
    hh, ww = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    block = np.stack([np.full(grid * grid, t0), t0 + hh.ravel(), t0 + ww.ravel()])
    start = t0 + grid
    pos = np.concatenate([np.tile(np.arange(text), (3, 1)), block,
                          np.tile(np.arange(start, start + text), (3, 1))], axis=1)
    return pos[None].astype(np.int32)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in (VLM, ENCDEC):
        cfg = get_smoke_config(arch)
        params = M.init_params(cfg, seed=0, device="cpu")
        out[arch] = (ref_smoke_config(arch), tree_map(lambda a: jnp.asarray(a.numpy()), params),
                     cfg, params)
    return out


def as_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("sections", [(4, 2, 2), (2, 3, 3)])
def test_mrope_matches_reference(sections):
    rng = np.random.default_rng(sum(sections))
    x = rng.standard_normal((2, 11, 3, 16)).astype(np.float32)
    pos = mrope_positions(2, 11, 1)
    assert (pos[:, 0] != pos[:, 1]).any() and (pos[:, 1] != pos[:, 2]).any()
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sections)
    want = rl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # three equal rows are plain RoPE
    same = np.repeat(pos[:, :1], 3, axis=1)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(same), 1e6, sections).numpy(),
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(same[:, 0]), 1e6).numpy(),
        **TOL)


def test_gelu_mlp_matches_reference():
    rng = np.random.default_rng(2)
    args = [rng.standard_normal(shape).astype(np.float32) * 0.5
            for shape in ((2, 5, 12), (12, 20), (20,), (20, 12), (12,))]
    got = layers.gelu_mlp(*(torch.from_numpy(a) for a in args))
    want = rl.gelu_mlp(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------------ models


def vlm_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32),
            "positions": mrope_positions(b, s, seed)}


def encdec_batch(cfg, b, s, sm, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "src_embeds": rng.standard_normal((b, sm, cfg.d_model)).astype(np.float32)}


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_forward_train_matches_reference(models, arch):
    ref_cfg, ref_params, cfg, params = models[arch]
    batch = (vlm_batch(cfg, 2, 13, 3) if arch == VLM else encdec_batch(cfg, 2, 13, 9, 3))
    rh, _ = jax.jit(partial(RM.forward_train, ref_cfg))(ref_params, as_jax(batch))
    th, aux = M.forward_train(cfg, params, as_torch(batch))
    assert th.shape == (2, 13, cfg.d_model) and aux == {}
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), **MTOL)


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_prefill_and_greedy_decode_match_reference(models, arch):
    ref_cfg, ref_params, cfg, params = models[arch]
    b, s, sm, steps = 2, 12, 9, 5
    batch = (vlm_batch(cfg, b, s, 4) if arch == VLM else encdec_batch(cfg, b, s, sm, 4))
    kw = {"memory_len": sm} if arch == ENCDEC else {}
    rc = RM.init_cache(ref_cfg, b, s + steps, **kw)
    rh, rc = jax.jit(partial(RM.prefill, ref_cfg))(ref_params, as_jax(batch), rc)
    tc = M.init_cache(cfg, b, s + steps, device="cpu", **kw)
    th, tc = M.prefill(cfg, params, as_torch(batch), tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), **MTOL)
    ref_decode = jax.jit(partial(RM.decode_step, ref_cfg))
    tok = np.array([3, 7], np.int32)
    cur = np.full(b, s, np.int32)
    for _ in range(steps):
        rlog, rc = ref_decode(ref_params, rc, jnp.asarray(tok), jnp.asarray(cur))
        tlog, tc = M.decode_step(cfg, params, tc, torch.from_numpy(tok), torch.from_numpy(cur))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(rlog), **MTOL)
        tok = tlog[:, :cfg.vocab_size].argmax(dim=-1).numpy().astype(np.int32)
        np.testing.assert_array_equal(tok, np.asarray(jnp.argmax(rlog[:, :cfg.vocab_size], -1)))
        cur = cur + 1


# ------------------------------------------- the reference's own checks


def test_vlm_embeds_prefill_then_token_decode(models):
    """``tests/test_extras.py::test_vlm_embeds_prefill_then_token_decode``
    on the port."""
    _, _, cfg, params = models[VLM]
    rng = np.random.default_rng(0)
    b, s = 2, 12
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, 3, s)).copy()
    batch = {"embeds": torch.from_numpy(rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)),
             "positions": torch.from_numpy(pos)}
    cache = M.init_cache(cfg, b, s + 8, device="cpu")
    _, cache = M.prefill(cfg, params, batch, cache)
    logits, cache = M.decode_step(cfg, params, cache, torch.tensor([3, 7], dtype=torch.int32),
                                  torch.full((b,), s, dtype=torch.int32))
    assert logits.shape == (b, cfg.padded_vocab)
    assert torch.isfinite(logits[:, :cfg.vocab_size]).all()
    nxt = logits[:, :cfg.vocab_size].argmax(dim=-1).to(torch.int32)
    logits2, _ = M.decode_step(cfg, params, cache, nxt, torch.full((b,), s + 1, dtype=torch.int32))
    assert torch.isfinite(logits2[:, :cfg.vocab_size]).all()


def test_encdec_embeds_decode_consistency(models):
    """``tests/test_extras.py::test_encdec_embeds_decode_consistency`` on
    the port: decode through the cached memory KV equals the full
    forward's last logits."""
    _, _, cfg, params = models[ENCDEC]
    rng = np.random.default_rng(1)
    b, s, sm = 2, 10, 7
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)),
             "src_embeds": torch.from_numpy(rng.normal(size=(b, sm, cfg.d_model))
                                            .astype(np.float32))}
    hid, _ = M.forward_train(cfg, params, batch)
    ref = M.lm_logits(cfg, params, hid)[:, -1]
    cache = M.init_cache(cfg, b, s + 4, device="cpu", memory_len=sm)
    pre = dict(batch, tokens=batch["tokens"][:, :-1])
    _, cache = M.prefill(cfg, params, pre, cache)
    assert cache[0]["xk"].shape == (cfg.num_layers, b, sm, cfg.num_kv_heads, cfg.head_dim)
    logits, _ = M.decode_step(cfg, params, cache, batch["tokens"][:, -1],
                              torch.full((b,), s - 1, dtype=torch.int32))
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=2e-3, atol=2e-4)


# -------------------------------------------------------------- routes


def test_kernel_route_only_where_the_temporal_row_is_the_index(models, monkeypatch):
    """Both routes of one prefill agree where both apply; a temporal row
    that is not the index takes the plain route."""
    _, _, cfg, params = models[VLM]
    calls = []
    real = T.block_apply.__globals__["flash_attention"]
    monkeypatch.setitem(T.block_apply.__globals__, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    batch = as_torch(vlm_batch(cfg, 2, 12, 5))

    def run(b):
        T.reset_prefill_routes()
        calls.clear()
        h, _ = M.prefill(cfg, params, b, M.init_cache(cfg, 2, 16, device="cpu"))
        return h, dict(T.prefill_routes), len(calls)

    h_kernel, routes, n = run(batch)
    assert routes == {"kernel": 1, "plain": 0} and n == cfg.num_layers
    # the same positions, forced onto the plain route, give the same hidden
    monkeypatch.setattr(T, "_temporal_is_index", lambda positions: False)
    h_plain, routes, n = run(batch)
    assert routes == {"kernel": 0, "plain": 1} and n == 0
    np.testing.assert_allclose(h_kernel.numpy(), h_plain.numpy(), **TOL)
    monkeypatch.undo()
    # one row's temporal positions shifted: plain route
    shifted = dict(batch, positions=batch["positions"].clone())
    shifted["positions"][1, 0] += 1
    monkeypatch.setitem(T.block_apply.__globals__, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, routes, n = run(shifted)
    assert routes == {"kernel": 0, "plain": 1} and n == 0


def test_image_block_decode_matches_full_forward(models):
    """4 text tokens, a 3 x 3 image block, 4 text tokens: the first decode
    step's logits equal the full forward over the prompt and the token,
    and the prefill took the plain route."""
    _, _, cfg, params = models[VLM]
    pos = image_block_positions(4, 3)                      # [1, 3, 17]
    s = pos.shape[2]
    rng = np.random.default_rng(8)
    embeds = rng.standard_normal((1, s, cfg.d_model)).astype(np.float32)
    tok = torch.tensor([5], dtype=torch.int32)
    nxt = int(pos[0, 0, -1]) + 1
    T.reset_prefill_routes()
    _, cache = M.prefill(cfg, params, {"embeds": torch.from_numpy(embeds),
                                       "positions": torch.from_numpy(pos)},
                         M.init_cache(cfg, 1, s + 2, device="cpu"))
    assert T.prefill_routes == {"kernel": 0, "plain": 1}
    logits, _ = M.decode_step(cfg, params, cache, tok, torch.tensor([nxt], dtype=torch.int32))
    full = np.concatenate([embeds, T.embed_tokens(cfg, params, tok[:, None]).numpy()], axis=1)
    full_pos = np.concatenate([pos, np.full((1, 3, 1), nxt, np.int32)], axis=2)
    hid, _ = M.forward_train(cfg, params, {"embeds": torch.from_numpy(full),
                                           "positions": torch.from_numpy(full_pos)})
    np.testing.assert_allclose(logits.numpy(), M.lm_logits(cfg, params, hid)[:, -1].numpy(),
                               rtol=2e-3, atol=2e-4)
