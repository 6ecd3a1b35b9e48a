"""PyTorch port: the Mamba mixer (``repro_torch/models/ssm.py``) against the
JAX package's ``repro/models/ssm.py``, fp32, on the CPU.

The same numpy inputs go to both: the chunked ``selective_scan`` (a
doubling scan inside each chunk, where the reference runs
``jax.lax.associative_scan``) against the reference's chunked scan and its
sequential ``selective_scan_ref``, at a chunk that divides the length and
one that does not (the tail padded with ``dt = 0``), from a zero and from a
given state; the one-token ``selective_scan_decode`` chained over the
sequence; ``causal_conv1d`` with and without a carried state; and the
whole mixer, ``mamba_forward`` then a chain of ``mamba_decode``, on the
reference's initialised weights.  Tolerance fp32 2e-5
(``tests/test_kernels.py``).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as rssm
from repro.models.common import init_param_tree
from repro_torch.models import ssm

TOL = dict(atol=2e-5, rtol=2e-5)
B, S, D, N = 2, 40, 24, 4


def scan_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    dt = (0.05 + 0.1 * rng.random((B, S, D))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    C = rng.standard_normal((B, S, N)).astype(np.float32)
    A = -np.exp(rng.standard_normal((D, N))).astype(np.float32)
    Dv = rng.standard_normal(D).astype(np.float32)
    h0 = rng.standard_normal((B, D, N)).astype(np.float32)
    return x, dt, Bm, C, A, Dv, h0


def t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("chunk", [8, 16])          # 40 = 5 x 8; 16 leaves a tail of 8
@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan_matches_reference_scans(chunk, with_h0):
    x, dt, Bm, C, A, Dv, h0 = scan_inputs(chunk)
    h0 = h0 if with_h0 else None
    jx = [jnp.asarray(a) for a in (x, dt, Bm, C, A, Dv)]
    jh0 = None if h0 is None else jnp.asarray(h0)
    ry, rh = jax.jit(partial(rssm.selective_scan, chunk_size=chunk))(*jx, jh0)
    oy, oh = jax.jit(rssm.selective_scan_ref)(*jx, jh0)
    th0 = None if h0 is None else torch.from_numpy(h0.copy())
    ty, th = ssm.selective_scan(*t(x, dt, Bm, C, A, Dv), th0, chunk_size=chunk)
    sy, sh = ssm.selective_scan_ref(*t(x, dt, Bm, C, A, Dv), th0)
    for y, h in ((ry, rh), (oy, oh)):
        np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(h), **TOL)
    np.testing.assert_allclose(sy.numpy(), np.asarray(oy), **TOL)
    np.testing.assert_allclose(sh.numpy(), np.asarray(oh), **TOL)


def test_decode_chain_matches_reference():
    x, dt, Bm, C, A, Dv, h0 = scan_inputs(3)
    rdec = jax.jit(rssm.selective_scan_decode)
    rh, th = jnp.asarray(h0), torch.from_numpy(h0.copy())
    ta, tDv = t(A, Dv)
    for i in range(S):
        ry, rh = rdec(*(jnp.asarray(a[:, i]) for a in (x, dt, Bm, C)), jnp.asarray(A),
                      jnp.asarray(Dv), rh)
        ty, th = ssm.selective_scan_decode(*t(x[:, i], dt[:, i], Bm[:, i], C[:, i]), ta, tDv, th)
        np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), **TOL)
    # the chain ends where the whole-sequence scan does
    _, sh = ssm.selective_scan(*t(x, dt, Bm, C, A, Dv), torch.from_numpy(h0.copy()), chunk_size=16)
    np.testing.assert_allclose(th.numpy(), sh.numpy(), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 9, D)).astype(np.float32)
    w = rng.standard_normal((4, D)).astype(np.float32)
    b = rng.standard_normal(D).astype(np.float32)
    st = rng.standard_normal((B, 3, D)).astype(np.float32) if with_state else None
    ry, rs = rssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                None if st is None else jnp.asarray(st))
    ty, ts = ssm.causal_conv1d(*t(x, w, b), None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))


def test_mamba_forward_then_decode_match_reference():
    d_model, d_inner, dt_rank = 16, 32, 4
    p = init_param_tree(rssm.mamba_param_specs(d_model, d_inner, N, 4, dt_rank),
                        jax.random.key(2), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    # the port's initialisers give the reference's deterministic A_log and
    # a dt_bias in the same range
    spec = ssm.mamba_param_specs(d_model, d_inner, N, 4, dt_rank)
    gen = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(spec["A_log"].make(gen, torch.float32).numpy(), p["A_log"])
    dt = torch.nn.functional.softplus(spec["dt_bias"].make(gen, torch.float32))
    assert 1e-3 - 1e-6 <= dt.min() and dt.max() <= 1e-1 + 1e-6

    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 21, d_model)).astype(np.float32)
    ssm0, conv0 = rssm.mamba_state_init(B, d_inner, N, 4)
    ry, (rs, rc) = jax.jit(partial(rssm.mamba_forward, dt_rank=dt_rank, chunk_size=8))(
        p, jnp.asarray(x), ssm0, conv0)
    tssm0, tconv0 = ssm.mamba_state_init(B, d_inner, N, 4)
    ty, (ts, tc) = ssm.mamba_forward(tp, torch.from_numpy(x), tssm0, tconv0, dt_rank, 8)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(rc), **TOL)
    rdec = jax.jit(partial(rssm.mamba_decode, dt_rank=dt_rank))
    for i in range(4):
        tok = rng.standard_normal((B, 1, d_model)).astype(np.float32)
        ry, (rs, rc) = rdec(p, jnp.asarray(tok), rs, rc)
        ty, (ts, tc) = ssm.mamba_decode(tp, torch.from_numpy(tok), ts, tc, dt_rank)
        np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(rc), **TOL)
