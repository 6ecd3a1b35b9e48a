"""PyTorch port: package boundary and tree/array interop with the JAX package.

* importing ``repro_torch`` and every submodule loads neither ``jax`` nor any
  ``repro`` module;
* trees flatten in ``jax.tree_util`` order (dict keys sorted), and a
  ``NamedTuple`` (``AdamWState``) comes back as its own type;
* bf16 crosses numpy <-> torch bit-exactly;
* ``params_from_numpy`` keeps the reference tree's keys, shapes and dtypes;
* entry points default to the card and raise when there is none.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.models as RM
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro_torch import interop
from repro_torch.configs.registry import get_config, get_smoke_config

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def ref_params():
    """The JAX package's seeded smoke-model weights (fp32)."""
    return RM.init_params(ref_smoke_config("smollm-135m"), jax.random.key(0))


_GUARD = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "repro" or n.startswith("repro."))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference_module():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _GUARD], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [], f"repro_torch pulled in {res['bad']}"
    for mod in ("repro_torch.interop", "repro_torch.kernels.paged_attention.kernel",
                "repro_torch.kernels.flash_attention.kernel",
                "repro_torch.kernels.page_gather.ops", "repro_torch.kvcache.paged_kv",
                "repro_torch.models.transformer", "repro_torch.serve.engine",
                "repro_torch.launch.serve", "repro_torch.core.pattern",
                "repro_torch.train.optimizer", "repro_torch.train.loss",
                "repro_torch.train.train_step", "repro_torch.train.trainer",
                "repro_torch.train.paged_state", "repro_torch.train.ooc",
                "repro_torch.ckpt.checkpoint", "repro_torch.data.pipeline",
                "repro_torch.launch.train", "repro_torch.models.moe",
                "repro_torch.models.ssm", "repro_torch.configs.hymba_1p5b",
                "repro_torch.configs.mixtral_8x7b", "repro_torch.configs.phi3p5_moe",
                "repro_torch.models.xlstm", "repro_torch.configs.xlstm_1p3b",
                "repro_torch.configs.qwen2_vl_7b", "repro_torch.configs.seamless_m4t_medium",
                "repro_torch.distributed.sharding", "repro_torch.distributed.collectives",
                "repro_torch.distributed.elastic", "repro_torch.launch.mesh",
                "repro_torch.launch.specs", "repro_torch.launch.dryrun"):
        assert mod in res["imported"], f"{mod} was not walked"


def test_version_is_the_references():
    import repro
    import repro_torch

    assert repro_torch.__version__ == repro.__version__


def test_flatten_order_matches_jax_tree_util():
    tree = {"b": 1, "a": {"z": [3, 4], "c": (5, None, 6)}, "m": None,
            "k": [{"y": 7, "x": 8}]}
    leaves, treedef = interop.tree_flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree)
    assert interop.tree_unflatten(treedef, leaves) == tree
    # torch's own pytree keeps insertion order: the reason interop exists
    assert interop.tree_flatten({"b": 1, "a": 2})[0] == [2, 1]


def test_namedtuple_keeps_its_type_in_jax_leaf_order():
    import repro.train.optimizer as ropt
    from repro_torch.train.optimizer import AdamWState

    m = {"w": torch.ones(2), "b": [torch.zeros(3)]}
    state = AdamWState(step=torch.tensor(3, dtype=torch.int32), m=m,
                       v=interop.tree_map(lambda t: t + 1, m))
    leaves, treedef = interop.tree_flatten({"opt": state, "step": 3})
    back = interop.tree_unflatten(treedef, leaves)
    assert type(back["opt"]) is AdamWState and back["opt"].m["b"][0] is m["b"][0]
    mapped = interop.tree_map(lambda t: t, state)
    assert type(mapped) is AdamWState and int(mapped.step) == 3
    # the same tree in the JAX package flattens to the same leaves, in order
    ref = {"opt": ropt.AdamWState(step=np.asarray(3, np.int32),
                                  m={"w": np.ones(2), "b": [np.zeros(3)]},
                                  v={"w": np.full(2, 2.0), "b": [np.ones(3)]}), "step": 3}
    want = jax.tree_util.tree_leaves(ref)
    assert len(leaves) == len(want)
    for got, w in zip(leaves, want):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(w))


def test_param_tree_flatten_order_matches_reference_init(ref_params):
    from repro_torch.models.transformer import param_specs
    specs, _ = interop.tree_flatten(param_specs(get_smoke_config("smollm-135m")))
    assert [tuple(s.shape) for s in specs] == [
        tuple(a.shape) for a in jax.tree_util.tree_leaves(ref_params)]


def test_bf16_round_trip_is_bit_exact():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16)
    with pytest.raises(TypeError):
        torch.from_numpy(a)                       # why the bit-pattern detour
    t = interop.from_numpy(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    back = interop.to_numpy(t).view(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(back.view(np.uint16), a.view(np.uint16))
    # from a JAX array too
    j = jnp.asarray(a)
    np.testing.assert_array_equal(
        interop.to_numpy(interop.from_numpy(np.asarray(j))), a.view(np.uint16))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_from_numpy_keeps_keys_shapes_dtypes(ref_params, dtype):
    # init_params(dtype=bf16) is the fp32 draw cast to bf16
    ref = jax.tree_util.tree_map(lambda a: a.astype(dtype), ref_params)
    tree = jax.tree_util.tree_map(np.asarray, ref)
    params = interop.params_from_numpy(tree, device="cpu",
                                       cfg=get_smoke_config("smollm-135m"))
    want = jax.tree_util.tree_flatten_with_path(ref)[0]
    got, _ = interop.tree_flatten(params)
    assert len(got) == len(want)
    for (path, r), t in zip(want, got):
        assert tuple(t.shape) == tuple(r.shape), jax.tree_util.keystr(path)
        assert str(t.dtype).split(".")[-1] == str(r.dtype), jax.tree_util.keystr(path)
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(r, np.float32), err_msg=jax.tree_util.keystr(path))
    assert set(params) == set(ref)
    assert set(params["segments"][0]) == set(ref["segments"][0])


def test_params_from_numpy_rejects_nonzero_padded_head_rows(ref_params):
    tree = jax.tree_util.tree_map(np.array, ref_params)
    tree["segments"][0]["attn"]["wo"][0, -1, 0] = 1.0    # a padded head's row
    with pytest.raises(ValueError, match="padded-head"):
        interop.params_from_numpy(tree, device="cpu",
                                  cfg=get_smoke_config("smollm-135m"))


def test_registry_offers_only_ported_architectures():
    assert get_config("smollm-135m").num_layers == 30
    assert get_config("qwen2-1.5b").head_dim == 128
    assert get_config("llama3-8b").num_kv_heads == 8
    assert not get_config("deepseek-7b").tie_embeddings
    assert get_config("mixtral-8x7b").num_experts == 8
    assert get_config("phi3.5-moe-42b-a6.6b").num_experts == 16
    assert get_config("hymba-1.5b").num_meta_tokens == 128
    # every architecture of the JAX package builds, equal to its reference
    import dataclasses
    from repro.configs import registry as ref_registry
    from repro_torch.configs.registry import ARCH_IDS
    assert set(ARCH_IDS) == set(ref_registry.ARCH_IDS)
    for arch in ARCH_IDS:
        for mine, ref in ((get_config(arch), ref_registry.get_config(arch)),
                          (get_smoke_config(arch), ref_registry.get_smoke_config(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), arch
    assert get_config("xlstm-1.3b").slstm_every == 8
    assert get_config("qwen2-vl-7b").padded_heads == 32
    assert get_config("seamless-m4t-medium").padded_vocab == 256256
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "qwen2-vl-7b", "seamless-m4t-medium"])
def test_param_trees_of_the_rest_of_the_zoo_match_the_reference(arch):
    """The port's parameter tree (keys, shapes, logical axes) equals the JAX
    package's for the smoke config, and ``params_from_numpy`` carries such
    a tree across with its padded heads' ``wo`` rows checked in every
    attention and cross-attention (qwen2-vl pads 7 heads to 8)."""
    from repro.models.transformer import param_specs as ref_specs
    from repro_torch.models.transformer import init_params, param_specs

    cfg = get_smoke_config(arch)
    mine, ref = param_specs(cfg), ref_specs(ref_smoke_config(arch))
    m_leaves, m_def = interop.tree_flatten(mine)
    r_leaves = jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: hasattr(x, "logical_axes"))[0]
    assert len(m_leaves) == len(r_leaves)
    for got, (path, want) in zip(m_leaves, r_leaves):
        assert (got.shape, got.logical_axes) == (tuple(want.shape), tuple(want.logical_axes)), \
            jax.tree_util.keystr(path)
    tree = interop.tree_map(lambda t: t.numpy(), init_params(cfg, 0, device="cpu"))
    back = interop.params_from_numpy(tree, device="cpu", cfg=cfg)
    assert interop.tree_flatten(back)[1] == m_def
    if cfg.padded_heads != cfg.num_heads:
        tree["segments"][0]["attn"]["wo"][0, -1, 0] = 1.0
        with pytest.raises(ValueError, match="padded-head"):
            interop.params_from_numpy(tree, device="cpu", cfg=cfg)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    import repro_torch.models as M
    from repro_torch.kvcache.paged_kv import PagedKVCache, PagedKVConfig
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.serve.engine import EngineConfig, ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("smollm-135m")
    with pytest.raises(RuntimeError, match="cuda"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        PagedKVCache(PagedKVConfig(num_layers=1, num_kv_heads=1, head_dim=4))
    params = M.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, params, EngineConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        serve_main(["--arch", "smollm-135m", "--smoke"])
