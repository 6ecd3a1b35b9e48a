"""PyTorch port: the MoE, hybrid and recurrent decoders against the JAX
package, fp32.

The smoke configs of mixtral-8x7b, phi3.5-moe-42b-a6.6b, hymba-1.5b and
xlstm-1.3b (MoE blocks; attention and Mamba side by side with meta tokens
and sliding windows; mLSTM and sLSTM blocks with per-lane state only),
and for training also qwen2-vl-7b (patch embeddings, M-RoPE) and
seamless-m4t-medium (encoder-decoder), the port's seeded weights handed
to the JAX package through numpy, inputs from numpy seeds:

* ``prefill`` + greedy ``decode_step`` (xlstm's: ``test_torch_xlstm.py``):
  logits within 1e-4 (the tolerance
  of the dense parity in ``test_torch_models.py``), tokens equal;
* ``forward_train`` hidden and aux within 1e-4, and ``loss_fn``'s loss
  (rtol 1e-5) and gradient norm (rtol 1e-4, as ``test_torch_train.py``),
  with ``remat="full"`` and without (the two bitwise equal in the port);
* the serving engine against the JAX engine for prompts whose prefill fits
  the window, with a registered prefix and copy-on-write: tokens and
  counters equal (xlstm-1.3b too, whose lanes hold state only);
* past the window, the engine against the JAX package's contiguous decode
  of each prompt alone (the JAX engine installs its prefill ring there as
  if it were contiguous; ROADMAP.md, divergences of the reference);
* the serving and training launchers on the CPU with ``--smoke`` (the
  stub-frontend architectures train; the engine refuses them, as the JAX
  engine does).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as RM
import repro.serve.engine as jax_engine
import repro.train.train_step as rts
import repro_torch.models as M
import repro_torch.serve.engine as torch_engine
import repro_torch.train.train_step as ts
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro_torch.configs.registry import get_smoke_config
from repro_torch.interop import tree_flatten, tree_map
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import stub_frontend

ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "hymba-1.5b"]
ENGINE_ARCHS = ARCHS + ["xlstm-1.3b"]         # its decode: test_torch_xlstm.py
TRAIN_ARCHS = ENGINE_ARCHS + ["qwen2-vl-7b", "seamless-m4t-medium"]
WINDOW = 8                  # the smoke configs' window (phi has none: the same sizes)
TOL = dict(atol=1e-4, rtol=1e-4)
COUNTERS = ("prefix_hits", "cow_copies", "steps", "prefills", "evictions",
            "shared_pages_mapped", "peak_pages_used")


@pytest.fixture(scope="module")
def zoo():
    """(reference cfg, reference params, port cfg, port params): the port's
    seeded weights, fed to the JAX package through numpy (its own eager
    initialisation of these trees takes seconds on the CPU)."""
    out = {}
    for arch in TRAIN_ARCHS:
        cfg = get_smoke_config(arch)
        params = M.init_params(cfg, seed=0, device="cpu")
        out[arch] = (ref_smoke_config(arch), tree_map(lambda t: jnp.asarray(t.numpy()), params),
                     cfg, params)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_reference(zoo, arch):
    ref_cfg, ref_params, cfg, params = zoo[arch]
    rng = np.random.default_rng(0)
    B, S, steps = 2, 11, 8                  # past the smoke window of 8
    m = cfg.num_meta_tokens
    prompt = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    rc = RM.init_cache(ref_cfg, B, S + steps + m + 4)
    rh, rc = jax.jit(partial(RM.prefill, ref_cfg))(ref_params, {"tokens": jnp.asarray(prompt)}, rc)
    tc = M.init_cache(cfg, B, S + steps + m + 4, device="cpu")
    th, tc = M.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)}, tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), **TOL)
    ref_decode = jax.jit(partial(RM.decode_step, ref_cfg))
    rtok = ttok = rng.integers(1, cfg.vocab_size, size=B).astype(np.int32)
    cur = np.full(B, S + m, np.int32)
    for _ in range(steps):
        rl, rc = ref_decode(ref_params, rc, jnp.asarray(rtok), jnp.asarray(cur))
        tl, tc = M.decode_step(cfg, params, tc, torch.from_numpy(ttok), torch.from_numpy(cur))
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
        rtok = np.asarray(jnp.argmax(rl, axis=-1)).astype(np.int32)
        ttok = tl.argmax(dim=-1).numpy().astype(np.int32)
        np.testing.assert_array_equal(ttok, rtok)
        cur = cur + 1


def grad_norm(leaves):
    return float(np.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2)) for g in leaves)))


def train_batch(cfg, seed):
    """20 positions of next-token labels; a stub-frontend model's
    embeddings as ``launch/train.py`` draws them."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, size=(2, 21)).astype(np.int32)
    batch = {"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()}
    return next(stub_frontend(cfg, [batch], seed))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_forward_train_and_loss_match_reference(zoo, arch):
    ref_cfg, ref_params, cfg, params = zoo[arch]
    batch = train_batch(cfg, 1)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    rh, raux = jax.jit(partial(RM.forward_train, ref_cfg))(
        ref_params, {k: jnp.asarray(v) for k, v in inputs.items()})
    th, taux = M.forward_train(cfg, params, {k: torch.from_numpy(v) for k, v in inputs.items()})
    assert th.shape == (2, 20, cfg.d_model)          # the meta prefix is stripped
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), **TOL)
    assert set(taux) == set(raux) == ({"moe_lb_loss", "moe_z_loss", "moe_drop_frac"}
                                      if cfg.num_experts else set())
    for k, v in taux.items():
        np.testing.assert_allclose(v.item(), float(raux[k]), **TOL)

    rtcfg, tcfg = rts.TrainConfig(loss_chunk=8), ts.TrainConfig(loss_chunk=8)
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(partial(rts.loss_fn, ref_cfg, rtcfg),
                                                    has_aux=True))(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = [ts.value_and_grad(cfg.replace(remat=r), tcfg, params, tb) for r in ("none", "full")]
    for loss, _, grads in out:
        np.testing.assert_allclose(loss.item(), float(rloss), rtol=1e-5)
        np.testing.assert_allclose(grad_norm([g.numpy() for g in tree_flatten(grads)[0]]),
                                   grad_norm(jax.tree_util.tree_leaves(rgrads)), rtol=1e-4)
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_flatten(out[0][2])[0], tree_flatten(out[1][2])[0]):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ engine


def within_window(mod, cfg, make):
    """Prompts whose prefill (meta tokens included) fits the smoke window of
    8, over pages of 2, with a 3-token registered prefix: prompts that
    extend it copy the boundary page at prefill, prompts equal to it on
    the first decode; 6 new tokens carry every lane past the window."""
    eng = make(mod.EngineConfig(max_batch=3, page_size=2, num_pages=96,
                                max_pages_per_seq=16, prefill_bucket=4))
    rng = np.random.default_rng(5)
    room = WINDOW - cfg.num_meta_tokens                  # prefilled prompt[:-1] fits
    prefix = rng.integers(1, cfg.vocab_size, 3).astype(np.int32)
    eng.register_prefix(prefix)
    reqs = []
    for i in range(6):
        if i % 3 == 0:
            p = prefix.copy()
        elif i % 3 == 1:
            p = np.concatenate([prefix, rng.integers(1, cfg.vocab_size, room - 2).astype(np.int32)])
        else:
            p = rng.integers(1, cfg.vocab_size, int(rng.integers(2, room + 2))).astype(np.int32)
        assert len(p) - 1 + cfg.num_meta_tokens <= WINDOW
        reqs.append(mod.Request(rid=i, prompt=p, max_new_tokens=6))
        eng.submit(reqs[-1])
    return eng, reqs


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_within_the_window_matches_reference_engine(zoo, arch, monkeypatch):
    ref_cfg, ref_params, cfg, params = zoo[arch]
    monkeypatch.setattr(jax_engine.T, "prefill", jax.jit(RM.prefill, static_argnums=0))
    out = {}
    for name, mod, c, p, kw in (("jax", jax_engine, ref_cfg, ref_params, {}),
                                ("torch", torch_engine, cfg, params, {"device": "cpu"})):
        eng, reqs = within_window(mod, c, lambda ecfg: mod.ServeEngine(c, p, ecfg, **kw))
        eng.run_until_drained(max_steps=500)
        assert not eng.waiting and not eng.active
        prefix_pages = sum(len(e.pages) for e in eng._prefixes.values())
        assert eng.allocator.used_pages == 1 + prefix_pages
        out[name] = ({r.rid: list(r.generated) for r in reqs},
                     {k: eng.stats[k] for k in COUNTERS})
    assert out["torch"] == out["jax"]
    gen, stats = out["torch"]
    assert all(len(g) == 6 for g in gen.values())
    assert stats["prefix_hits"] == 4 and stats["cow_copies"] >= 2


def contiguous_decode(ref_cfg, ref_params, prompt, n_new):
    """The JAX package's greedy decode of one prompt alone: prefill
    ``prompt[:-1]`` into a contiguous (ring, for a window) cache, then
    decode from the last prompt token, positions counting the meta
    tokens, as the engine's ``eff`` does."""
    m = ref_cfg.num_meta_tokens
    cache = RM.init_cache(ref_cfg, 1, len(prompt) + n_new + m + 1)
    _, cache = jax.jit(partial(RM.prefill, ref_cfg))(
        ref_params, {"tokens": jnp.asarray(prompt[None, :-1])}, cache)
    step = jax.jit(partial(RM.decode_step, ref_cfg))
    tok, cur, out = int(prompt[-1]), len(prompt) - 1 + m, []
    for _ in range(n_new):
        logits, cache = step(ref_params, cache, jnp.asarray([tok], jnp.int32),
                             jnp.asarray([cur], jnp.int32))
        tok = int(jnp.argmax(logits[0]))
        out.append(tok)
        cur += 1
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_past_the_window_matches_reference_contiguous_decode(zoo, arch):
    """Two prompts of 25 tokens (one length: one reference compile),
    windows of 8: one lane and a bucket of 1, so the engine's expert
    dispatch sees the tokens unbatched decode does."""
    ref_cfg, ref_params, cfg, params = zoo[arch]
    eng = torch_engine.ServeEngine(cfg, params, torch_engine.EngineConfig(
        max_batch=1, page_size=4, num_pages=64, max_pages_per_seq=16, prefill_bucket=1),
        device="cpu")
    rng = np.random.default_rng(7)
    reqs = [torch_engine.Request(rid=i, max_new_tokens=6, prompt=rng.integers(
        1, cfg.vocab_size, 25).astype(np.int32)) for i in range(2)]
    for r in reqs:
        assert len(r.prompt) - 1 + cfg.num_meta_tokens > 2 * WINDOW
        eng.submit(r)
    eng.run_until_drained(max_steps=100)
    assert eng.allocator.used_pages == 1 and not eng.active
    for r in reqs:
        assert r.generated == contiguous_decode(ref_cfg, ref_params, r.prompt, 6), r.rid


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_launchers_run_on_cpu(arch, capsys):
    served = serve_main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--requests", "2", "--max-new", "3"])
    if arch in ENGINE_ARCHS:
        assert served == 0
        assert "served 2/2 requests, 6 tokens" in capsys.readouterr().out
    else:
        assert served == 2 and "decoder-only token models" in capsys.readouterr().err
    assert train_main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "16"]) == 0
    losses = [float(ln.split()[3]) for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
