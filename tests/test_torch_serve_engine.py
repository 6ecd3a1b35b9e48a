"""PyTorch port: the serving engine rerun beside the JAX one.

Three scenarios of ``tests/test_serve_engine.py`` run in both packages on
the smollm smoke model (the JAX package's weights, converted): the
pool-exhaustion boundary, the seeded three-tenant storm, and prefix sharing
with copy-on-write.  A fourth serves prompts of a few hundred tokens on the
qwen2 smoke model, whose prefill takes the ``flash_attention`` route.  Generated tokens must be equal byte for byte, and the
counters ``prefix_hits``, ``cow_copies``, ``shed_requests`` and ``expired``
(plus the scheduling counters) equal.  The port's launcher runs once on the
CPU as well.
"""

import jax
import numpy as np
import pytest

import repro.models as RM
import repro.serve.engine as jax_engine
import repro_torch.models as M
import repro_torch.serve.engine as torch_engine
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro_torch.configs.registry import get_smoke_config
from repro_torch.interop import params_from_numpy, tree_map
from repro_torch.launch.serve import main as serve_main

COUNTERS = ("prefix_hits", "cow_copies", "shed_requests", "expired", "steps",
            "prefills", "evictions", "requeues", "victim_evictions",
            "shared_pages_mapped", "peak_pages_used")


def _jit_reference_prefill(monkeypatch):
    # the JAX engine calls prefill eagerly (one trace per request); jit it so
    # each bucket shape compiles once — same function, a fraction of the time
    monkeypatch.setattr(jax_engine.T, "prefill", jax.jit(RM.prefill, static_argnums=0))


@pytest.fixture
def both(models, monkeypatch):
    _jit_reference_prefill(monkeypatch)
    return models


@pytest.fixture
def both_qwen2(monkeypatch):
    """qwen2 smoke (QKV bias, 6 heads padded to 8 over 2 KV heads), the
    port's seeded weights fed to both packages."""
    _jit_reference_prefill(monkeypatch)
    ref_cfg = ref_smoke_config("qwen2-1.5b")
    cfg = get_smoke_config("qwen2-1.5b")
    params = M.init_params(cfg, seed=0, device="cpu")
    ref_params = tree_map(lambda t: jax.numpy.asarray(t.numpy()), params)
    return {"jax": (jax_engine, ref_cfg, ref_params, {}),
            "torch": (torch_engine, cfg, params, {"device": "cpu"})}


@pytest.fixture(scope="module")
def models():
    ref_cfg = ref_smoke_config("smollm-135m")
    ref_params = RM.init_params(ref_cfg, jax.random.key(0))
    cfg = get_smoke_config("smollm-135m")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params),
                               device="cpu", cfg=cfg)
    return {"jax": (jax_engine, ref_cfg, ref_params, {}),
            "torch": (torch_engine, cfg, params, {"device": "cpu"})}


def run_both(both, scenario):
    out = {}
    for name, (mod, cfg, params, kw) in both.items():
        eng, reqs = scenario(mod, cfg, lambda ecfg: mod.ServeEngine(cfg, params, ecfg, **kw))
        eng.run_until_drained(max_steps=1000)
        assert not eng.waiting and not eng.active
        prefix_pages = sum(len(e.pages) for e in eng._prefixes.values())
        assert eng.allocator.used_pages == 1 + prefix_pages
        out[name] = ({r.rid: list(r.generated) for r in reqs},
                     {k: eng.stats[k] for k in COUNTERS}, eng.stats["per_tenant"])
    assert out["torch"][0] == out["jax"][0], "generated tokens differ"
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][2] == out["jax"][2]
    return out["torch"]


def exhaustion_boundary(mod, cfg, make):
    """Two adjacent lanes cross a page boundary with the pool full."""
    eng = make(mod.EngineConfig(max_batch=2, page_size=4, num_pages=7,
                                max_pages_per_seq=8, prefill_bucket=8,
                                prefix_sharing=False))
    rng = np.random.default_rng(3)
    reqs = [mod.Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, 5).astype(np.int32),
                        max_new_tokens=10) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    return eng, reqs


def tenant_storm(mod, cfg, make):
    """Seeded 3-tenant storm under pool pressure with a shared prefix."""
    eng = make(mod.EngineConfig(max_batch=4, page_size=4, num_pages=48,
                                max_pages_per_seq=16, prefill_bucket=8))
    eng.add_tenant(mod.Tenant("gold", weight=4.0, priority=2))
    eng.add_tenant(mod.Tenant("silver", weight=2.0, priority=1))
    eng.add_tenant(mod.Tenant("bronze", weight=1.0, priority=0))
    rng = np.random.default_rng(11)
    prefix = rng.integers(1, cfg.vocab_size, 8).astype(np.int32)
    eng.register_prefix(prefix, tenant="gold")
    reqs = []
    for i in range(12):
        if i % 2:
            p = np.concatenate([prefix, rng.integers(1, cfg.vocab_size, 3).astype(np.int32)])
        else:
            p = rng.integers(1, cfg.vocab_size, 6).astype(np.int32)
        reqs.append(mod.Request(rid=i, prompt=p, max_new_tokens=5,
                                tenant=("gold", "silver", "bronze")[i % 3]))
        eng.submit(reqs[-1])
    return eng, reqs


def prefix_cow(mod, cfg, make):
    """A 10-token prefix (not page-aligned): prompts that extend it COW the
    boundary page at prefill, prompts equal to it COW on the first decode."""
    eng = make(mod.EngineConfig(max_batch=4, page_size=4, num_pages=96,
                                max_pages_per_seq=16, prefill_bucket=8))
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, cfg.vocab_size, 10).astype(np.int32)
    eng.register_prefix(prefix)
    reqs = []
    for i in range(8):
        p = prefix if i % 2 else np.concatenate(
            [prefix, rng.integers(1, cfg.vocab_size, 3).astype(np.int32)])
        reqs.append(mod.Request(rid=i, prompt=p.copy(), max_new_tokens=4))
        eng.submit(reqs[-1])
    return eng, reqs


def long_prompts(mod, cfg, make):
    """Prompts of a few hundred tokens over page 8, two lanes: each prefill
    (bucket 256 or 384) installs 19-48 pages, and decode crosses pages."""
    eng = make(mod.EngineConfig(max_batch=2, page_size=8, num_pages=160,
                                max_pages_per_seq=56, prefill_bucket=128))
    rng = np.random.default_rng(9)
    reqs = [mod.Request(rid=i, max_new_tokens=6, prompt=rng.integers(
        1, cfg.vocab_size, int(rng.integers(150, 380))).astype(np.int32)) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    return eng, reqs


def test_long_prompts_match_reference(both_qwen2):
    gen, stats, _ = run_both(both_qwen2, long_prompts)
    assert stats["prefills"] == 4 and all(len(g) == 6 for g in gen.values())
    assert stats["peak_pages_used"] > 60


def test_pool_exhaustion_boundary_matches_reference(both):
    _, stats, _ = run_both(both, exhaustion_boundary)
    assert stats["evictions"] >= 1, "scenario must actually exhaust the pool"


def test_multi_tenant_storm_matches_reference(both):
    gen, stats, _ = run_both(both, tenant_storm)
    assert stats["prefix_hits"] >= 1
    assert all(len(g) == 5 for g in gen.values())


def test_prefix_sharing_cow_matches_reference(both):
    _, stats, _ = run_both(both, prefix_cow)
    assert stats["prefix_hits"] == 8 and stats["cow_copies"] > 0


def test_launcher_runs_on_cpu(capsys):
    assert serve_main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "served 3/3 requests, 9 tokens" in out and "on cpu" in out



def test_engine_times_each_prefill():
    """The port's engine adds each prefill's time to its request (host time
    on the CPU, device time between CUDA events on the card)."""
    cfg = get_smoke_config("smollm-135m")
    eng = torch_engine.ServeEngine(cfg, M.init_params(cfg, seed=0, device="cpu"),
                                   torch_engine.EngineConfig(
                                       max_batch=2, page_size=8, num_pages=64,
                                       max_pages_per_seq=16, prefill_bucket=16), device="cpu")
    rng = np.random.default_rng(3)
    for rid in range(3):
        eng.submit(torch_engine.Request(rid=rid, max_new_tokens=2, prompt=rng.integers(
            1, cfg.vocab_size, 12).astype(np.int32)))
    eng.run_until_drained(max_steps=100)
    assert len(eng.finished) == 3 and not eng._pending_prefills
    assert all(r.prefill_ms > 0 for r in eng.finished)
