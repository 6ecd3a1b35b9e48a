"""PyTorch port: the xLSTM blocks (``repro_torch/models/xlstm.py``) and the
xlstm-smoke model against the JAX package's ``repro/models/xlstm.py``,
fp32, on the CPU.

The same numpy inputs go to both:

* within the port, the chunked mLSTM against its sequential oracle at
  chunks that divide the length and chunks that leave a tail, from a zero
  and from a given state (``tests/test_scan_layers.py`` holds the
  reference's pair to atol 1e-3 / rtol 1e-2; the port's pair holds to
  2e-5);
* ``mlstm_ref``, ``mlstm_chunked``, ``slstm_scan`` and the two block
  forwards, a prefill then a chain of one-token steps carrying the state,
  against the JAX functions: 2e-5 (``tests/test_kernels.py``);
* the xlstm-smoke model (mLSTM blocks, an sLSTM block every 4th): its
  cache layout, and prefill + greedy decode against the JAX package.  Its
  serving engine (purely recurrent: per-lane state, no pages read,
  exact-length prefill) is held to the JAX engine's tokens and counters in
  ``test_torch_zoo.py``, with the rest of the zoo.
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
from repro.models import xlstm as rx
from repro.models.common import init_param_tree
from repro_torch.configs.registry import get_smoke_config
from repro_torch.interop import tree_map
from repro_torch.models import xlstm

TOL = dict(atol=2e-5, rtol=2e-5)
B, S, H, DK, DV = 2, 37, 2, 8, 16


def mlstm_inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, DK)).astype(np.float32)
    k = (0.5 * rng.standard_normal((B, S, H, DK))).astype(np.float32)
    v = rng.standard_normal((B, S, H, DV)).astype(np.float32)
    ig = rng.standard_normal((B, S, H)).astype(np.float32)
    fg = (rng.standard_normal((B, S, H)) + 2.0).astype(np.float32)
    state = (rng.standard_normal((B, H, DV, DK)).astype(np.float32),
             rng.standard_normal((B, H, DK)).astype(np.float32),
             rng.standard_normal((B, H)).astype(np.float32))
    return (q, k, v, ig, fg), state


def t(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def close(got, want):
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("chunk", [4, 8, 16, 37])       # 37 = S; the rest leave a tail
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunked_matches_ref_in_the_port(chunk, with_state):
    inputs, state = mlstm_inputs(chunk)
    st = t(state) if with_state else None
    y, s1 = xlstm.mlstm_chunked(*t(inputs), state=st, chunk_size=chunk)
    yr, sr = xlstm.mlstm_ref(*t(inputs), state=st)
    close([y.numpy(), *(a.numpy() for a in s1)], [yr.numpy(), *(a.numpy() for a in sr)])


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_matches_reference(with_state):
    inputs, state = mlstm_inputs(5)
    st, jst = (t(state), j(state)) if with_state else (None, None)
    want_ref = jax.jit(rx.mlstm_ref)(*j(inputs), jst)
    want_chunked = jax.jit(partial(rx.mlstm_chunked, chunk_size=8))(*j(inputs), jst)
    got_ref = xlstm.mlstm_ref(*t(inputs), state=st)
    got_chunked = xlstm.mlstm_chunked(*t(inputs), state=st, chunk_size=8)
    for got, want in ((got_ref, want_ref), (got_chunked, want_chunked)):
        close([got[0].numpy(), *(a.numpy() for a in got[1])],
              [want[0], *want[1]])


def test_slstm_scan_matches_reference():
    rng = np.random.default_rng(3)
    d = 8
    xs = [rng.standard_normal((B, S, H, d)).astype(np.float32) for _ in range(4)]
    rs = [(rng.standard_normal((H, d, d)) / np.sqrt(d)).astype(np.float32) for _ in range(4)]
    y, st = xlstm.slstm_scan(*t(xs), *t(rs))
    ry, rst = jax.jit(rx.slstm_scan)(*j(xs), *j(rs))
    close([y.numpy(), *(a.numpy() for a in st)], [ry, *rst])
    # the state carries: two halves equal the whole
    y1, st1 = xlstm.slstm_scan(*t(a[:, :20] for a in xs), *t(rs))
    y2, st2 = xlstm.slstm_scan(*t(a[:, 20:] for a in xs), *t(rs), state=st1)
    close([torch.cat([y1, y2], 1).numpy(), *(a.numpy() for a in st2)],
          [y.numpy(), *(a.numpy() for a in st)])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_forward_prefill_then_decode_matches_reference(kind):
    """A 13-token prefill, then five one-token steps carrying state and
    conv state, on the reference's initialised block weights."""
    d_model, heads = 32, 2
    specs = (rx.mlstm_block_specs(d_model, heads) if kind == "mlstm"
             else rx.slstm_block_specs(d_model, heads))
    rp = init_param_tree(specs, jax.random.key(4), jnp.float32)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), rp)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 18, d_model)).astype(np.float32)
    if kind == "mlstm":
        rf = jax.jit(partial(rx.mlstm_block_forward, num_heads=heads, chunk_size=8))
        rdec = jax.jit(partial(rx.mlstm_block_forward, num_heads=heads, decode=True))

        def tf(p, xx, state=None, conv_state=None, decode=False):
            return xlstm.mlstm_block_forward(p, xx, heads, state, conv_state,
                                             chunk_size=8, decode=decode)
    else:
        rf = rdec = jax.jit(partial(rx.slstm_block_forward, num_heads=heads))

        def tf(p, xx, state=None, conv_state=None, decode=False):
            return xlstm.slstm_block_forward(p, xx, heads, state, conv_state)
    ry, (rs, rc) = rf(rp, jnp.asarray(x[:, :13]))
    ty, (ts, tc) = tf(tp, torch.from_numpy(x[:, :13].copy()))
    close([ty.numpy(), tc.numpy(), *(a.numpy() for a in ts)], [ry, rc, *rs])
    for i in range(13, 18):
        ry, (rs, rc) = rdec(rp, jnp.asarray(x[:, i:i + 1]), state=rs, conv_state=rc)
        ty, (ts, tc) = tf(tp, torch.from_numpy(x[:, i:i + 1].copy()), ts, tc, decode=True)
        close([ty.numpy(), tc.numpy(), *(a.numpy() for a in ts)], [ry, rc, *rs])


# ------------------------------------------------------------------- model


@pytest.fixture(scope="module")
def smoke():
    """(reference cfg, reference params, port cfg, port params): the port's
    seeded weights, fed to the JAX package through numpy."""
    cfg = get_smoke_config("xlstm-1.3b")
    params = M.init_params(cfg, seed=0, device="cpu")
    return (ref_smoke_config("xlstm-1.3b"),
            tree_map(lambda a: jnp.asarray(a.numpy()), params), cfg, params)


def test_plan_is_mlstm_with_an_slstm_every_fourth(smoke):
    _, _, cfg, params = smoke
    assert [(s.kind, s.count) for s in cfg.decoder_plan()] == [("mlstm", 3), ("slstm", 1)]
    cache = M.init_cache(cfg, 2, 8, device="cpu")
    assert set(cache[0]) == {"C", "n", "m", "conv"}
    assert set(cache[1]) == {"c", "n", "m", "h", "conv"}
    assert cache[0]["C"].dtype == torch.float32 and cache[0]["C"].shape[:2] == (3, 2)


def test_prefill_and_greedy_decode_match_reference(smoke):
    ref_cfg, ref_params, cfg, params = smoke
    rng = np.random.default_rng(0)
    b, s, steps = 2, 19, 6
    prompt = rng.integers(1, cfg.vocab_size, size=(b, s)).astype(np.int32)
    rc = RM.init_cache(ref_cfg, b, s + steps)
    rh, rc = jax.jit(partial(RM.prefill, ref_cfg))(ref_params, {"tokens": jnp.asarray(prompt)}, rc)
    tc = M.init_cache(cfg, b, s + steps, device="cpu")
    th, tc = M.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)}, tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), atol=1e-4, rtol=1e-4)
    ref_decode = jax.jit(partial(RM.decode_step, ref_cfg))
    tok = rng.integers(1, cfg.vocab_size, size=b).astype(np.int32)
    cur = np.full(b, s, np.int32)
    for _ in range(steps):
        rl, rc = ref_decode(ref_params, rc, jnp.asarray(tok), jnp.asarray(cur))
        tl, tc = M.decode_step(cfg, params, tc, torch.from_numpy(tok), torch.from_numpy(cur))
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), atol=1e-4, rtol=1e-4)
        tok = tl.argmax(dim=-1).numpy().astype(np.int32)
        np.testing.assert_array_equal(tok, np.asarray(jnp.argmax(rl, axis=-1)))
        cur = cur + 1
