"""PyTorch port: the MoE FFN (``repro_torch/models/moe.py``) against the
JAX package's ``repro/models/moe.py``, fp32, on the CPU.

The same numpy inputs and weights go through the port's ``moe_forward``
and the reference's ``moe_forward`` (no mesh: its dense dispatch,
``_moe_forward_dense``), for both parameter layouts (``tp``: experts
replicated, ``ep``: experts sharded) and at a capacity factor that drops
assignments and one that drops none.  Outputs and the three aux values
within fp32 2e-5 (``tests/test_kernels.py``), the dropped share exactly,
and the routing itself: the top-k expert ids equal, on inputs whose
router probabilities leave a margin of at least 1e-3 between the k-th
and the next expert (asserted), so no near-tie can flip a choice.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as rmoe
from repro.models.common import init_param_tree
from repro_torch.models import moe

TOL = dict(atol=2e-5, rtol=2e-5)
MARGIN = 1e-3


def inputs(seed, E, d=32, f=48, b=2, s=24, K=2):
    """Reference-initialised weights (as numpy) and tokens with a routing
    margin; the router is scaled up so that experts are well separated."""
    params = init_param_tree(rmoe.moe_param_specs(d, f, E, "tp"), jax.random.key(seed),
                             jnp.float32)
    params = {k: np.asarray(v) for k, v in params.items()}
    params["router"] = params["router"] * 50.0
    rng = np.random.default_rng(seed)
    cand = rng.standard_normal((8 * b * s, d)).astype(np.float32)
    top = -np.sort(-np.asarray(jax.nn.softmax(cand @ params["router"], axis=-1)), axis=-1)
    gaps = (top[:, :K] - top[:, 1:K + 1]).min(axis=1)   # each chosen expert over the next
    x = cand[gaps > MARGIN][:b * s]                       # tokens without a near-tie
    assert len(x) == b * s
    return params, x.reshape(b, s, d)


def run_both(params, x, K, cf, layout):
    ref = jax.jit(partial(rmoe.moe_forward, top_k=K, capacity_factor=cf, shard_local=True,
                          moe_sharding=layout))
    ry, raux = ref({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    ty, taux = moe.moe_forward({k: torch.from_numpy(v.copy()) for k, v in params.items()},
                               torch.from_numpy(x), K, cf, shard_local=True,
                               moe_sharding=layout)
    return (np.asarray(ry), {k: float(v) for k, v in raux.items()},
            ty.numpy(), {k: v.item() for k, v in taux.items()})


@pytest.mark.parametrize("layout", ["tp", "ep"])
@pytest.mark.parametrize("cf,drops", [(0.5, True), (4.0, False)])
def test_moe_forward_matches_reference(layout, cf, drops):
    E, K = (8, 2) if layout == "tp" else (16, 2)
    params, x = inputs(3, E)
    ry, raux, ty, taux = run_both(params, x, K, cf, layout)
    np.testing.assert_allclose(ty, ry, **TOL)
    assert set(taux) == set(raux) == {"moe_lb_loss", "moe_z_loss", "moe_drop_frac"}
    for k in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(taux[k], raux[k], **TOL)
    assert taux["moe_drop_frac"] == pytest.approx(raux["moe_drop_frac"], abs=1e-6)
    assert (taux["moe_drop_frac"] > 0.1) == drops
    if drops:
        # some token lost both of its assignments and gets exactly zero
        assert (np.abs(ty).reshape(-1, x.shape[-1]).max(axis=1) == 0).any()


def test_routing_matches_reference():
    params, x = inputs(4, 8)
    x2 = x.reshape(-1, x.shape[-1])
    rprobs = jax.nn.softmax(jnp.asarray(x2) @ jnp.asarray(params["router"]), axis=-1)
    rw, rids = jax.lax.top_k(rprobs, 2)
    rw = rw / jnp.maximum(rw.sum(-1, keepdims=True), 1e-9)
    _, probs, tw, tids = moe.route(torch.from_numpy(params["router"]), torch.from_numpy(x2), 2)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(rids))
    np.testing.assert_allclose(probs.numpy(), np.asarray(rprobs), **TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(rw), **TOL)
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, **TOL)


def test_capacity_uses_python_round_and_a_stable_sort():
    """cap = int(max(1, round(T*K/E*cf))) with Python's round (half to
    even: T*K/E*cf = 2.5 gives 2), and assignments kept in token order
    within an expert: with every token routed to experts 0 and 1 and a
    capacity of 2, tokens 0 and 1 keep both experts, tokens 2-4 get 0."""
    d, E, T = 4, 4, 5
    router = np.zeros((d, E), np.float32)
    router[0, 0], router[0, 1] = 10.0, 5.0
    x = np.zeros((1, T, d), np.float32)
    x[0, :, 0] = 1.0
    x[0, :, 1] = np.arange(1, T + 1)
    rng = np.random.default_rng(0)
    params = {"router": router,
              **{k: rng.standard_normal(shape).astype(np.float32) for k, shape in
                 (("w_gate", (E, d, 8)), ("w_up", (E, d, 8)), ("w_down", (E, 8, d)))}}
    cf = 2.5 * E / (T * 2)                                  # T*K/E*cf == 2.5
    ry, raux, ty, taux = run_both(params, x, 2, cf, "tp")
    np.testing.assert_allclose(ty, ry, **TOL)
    assert taux["moe_drop_frac"] == pytest.approx(0.6) == raux["moe_drop_frac"]
    assert (np.abs(ty[0, :2]).sum(axis=1) > 0).all() and (ty[0, 2:] == 0).all()
