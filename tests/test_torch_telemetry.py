"""PyTorch port: telemetry of the engine, KV cache and weight pager, and the
engine's prefix region and paging service on the port's own paging core.

* ``register_telemetry`` on the port's ``ServeEngine``, ``PagedKVCache``,
  ``LayerWeightPager`` and ``RegionLayerSource`` renders the golden metric
  families of ``tests/test_telemetry.py``, and the same text as the JAX
  package's collectors reading the same objects (the same state);
* the engine pins a priority tenant's prefix into the port's own
  ``TieredStore`` (as ``tests/test_serve_engine.py`` does for the
  reference), and reads degraded paging from the port's own
  ``PagingService.open_breakers``.
"""

import numpy as np
import pytest
import torch

import repro.telemetry.collectors as ref_collectors
import repro_torch.core as TC
import repro_torch.models as M
import repro_torch.serve.weight_pager as wp
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kvcache.paged_kv import PagedKVCache, PagedKVConfig
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine, Tenant
from repro_torch.telemetry import TelemetryRegistry
from test_telemetry import (
    SERVE_ENGINE_FAMILIES,
    SERVE_KV_FAMILIES,
    SERVE_TENANT_FAMILIES,
    SERVE_WEIGHT_FAMILIES,
    parse_exposition,
)

KV_LEASE_FAMILIES = {"umap_kv_leases_granted_total", "umap_kv_lease_blocked_evictions_total",
                     "umap_kv_leased_sequences"}
WEIGHT_LEASE_FAMILIES = {"umap_weight_staging_copies_total"}


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config("smollm-135m")
    return cfg, M.init_params(cfg, 0, device="cpu")


def families(registry):
    """Family names of a render, without the registry's own meta-families."""
    return {n for n in parse_exposition(registry.render()) if not n.startswith("umap_telemetry_")}


def render_with_reference(collector_name, label, **sources):
    """The JAX package's collector over the port's objects, rendered alone."""
    from repro.telemetry import TelemetryRegistry as RefRegistry

    reg = RefRegistry()
    reg.register(getattr(ref_collectors, collector_name)(label=label, **sources))
    return reg.render()


def samples(text):
    """Sample lines of a render, without the registries' self-telemetry."""
    return sorted(ln for ln in text.splitlines()
                  if ln and not ln.startswith("#") and not ln.startswith("umap_telemetry_"))


def drained_engine(cfg, params):
    eng = ServeEngine(cfg, params, EngineConfig(max_batch=2, page_size=4, num_pages=64,
                                                max_pages_per_seq=16, prefill_bucket=8),
                      device="cpu")
    eng.add_tenant(Tenant("gold", weight=2.0, priority=1))
    rng = np.random.default_rng(19)
    prefix = rng.integers(1, cfg.vocab_size, 8).astype(np.int32)
    eng.register_prefix(prefix, tenant="gold")
    reqs = [Request(rid=i, max_new_tokens=3, tenant="gold" if i % 2 else "default",
                    prompt=np.concatenate([prefix, rng.integers(1, cfg.vocab_size, 2)])
                    .astype(np.int32) if i % 2 else
                    rng.integers(1, cfg.vocab_size, 5).astype(np.int32)) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=200)
    assert len(eng.finished) == len(reqs)
    return eng


def test_engine_families_match_the_golden_names_and_the_reference(model):
    cfg, params = model
    eng = drained_engine(cfg, params)
    reg = TelemetryRegistry()
    name = eng.register_telemetry(registry=reg, label="port")
    assert name.startswith("serve")
    assert families(reg) == SERVE_ENGINE_FAMILIES | SERVE_TENANT_FAMILIES
    fams = parse_exposition(reg.render())
    assert fams["umap_serve_steps_total"]["samples"][0][2] == eng.stats["steps"]
    assert fams["umap_serve_prefix_hits_total"]["samples"][0][2] == eng.stats["prefix_hits"] > 0
    assert fams["umap_serve_paging_degraded"]["samples"][0][2] == 0
    assert samples(reg.render()) == samples(
        render_with_reference("ServeCollector", "port", engine=eng))


def test_kv_cache_families_match_the_golden_names_and_the_reference():
    kv = PagedKVCache(PagedKVConfig(num_layers=2, num_kv_heads=2, head_dim=8, page_size=4,
                                    num_pages=32, dtype="float32"), device="cpu")
    k = torch.arange(2 * 10 * 2 * 8, dtype=torch.float32).reshape(2, 10, 2, 8)
    kv.add_sequence(0, k, k + 1)
    with kv.lease_kv(0, layer=1):
        pass
    reg = TelemetryRegistry()
    names = kv.register_telemetry(registry=reg, label="kv")
    assert len(names) == 2
    assert families(reg) == SERVE_KV_FAMILIES | KV_LEASE_FAMILIES
    fams = parse_exposition(reg.render())
    assert fams["umap_kv_leases_granted_total"]["samples"][0][2] == 1
    assert fams["umap_kv_pages_used"]["samples"][0][2] == kv.stats()["pages_used"] > 0
    ref = render_with_reference("ServeCollector", "kv", kv=kv) + \
        render_with_reference("LeaseCollector", "kv", kv=kv)
    assert samples(reg.render()) == samples(ref)


def test_weight_pager_and_source_families_match_the_golden_names_and_the_reference():
    layers = [np.full((64,), i, np.float32) for i in range(4)]
    buf, specs = wp.pack_layer_arrays(layers, 256)
    region = TC.umap(TC.HostArrayStore(buf), config=TC.UMapConfig(page_size=256,
                                                                  buffer_size=16 * 256))
    try:
        src = wp.RegionLayerSource(region, specs, device="cpu", pool_pages=2)
        pager = wp.LayerWeightPager(src, num_slots=2, readahead=1, device="cpu")
        try:
            pager.run(torch.zeros(64), lambda p, x, i: x + p)
            reg = TelemetryRegistry()
            pager.register_telemetry(registry=reg, label="w")
            src.register_telemetry(registry=reg, label="w")
            assert families(reg) == SERVE_WEIGHT_FAMILIES | WEIGHT_LEASE_FAMILIES
            fams = parse_exposition(reg.render())
            assert fams["umap_weight_fills_total"]["samples"][0][2] == pager.stats["fills"] == 4
            assert fams["umap_weight_slots"]["samples"][0][2] == 2
            assert fams["umap_weight_staging_copies_total"]["samples"][0][2] == 0
            ref = render_with_reference("ServeCollector", "w", weight_pager=pager) + \
                render_with_reference("LeaseCollector", "w", weight_source=src)
            assert samples(reg.render()) == samples(ref)
        finally:
            pager.close()
    finally:
        TC.uunmap(region)


def test_priority_tenant_prefix_pinned_in_the_ports_tiered_store(model):
    """``tests/test_serve_engine.py``'s pin_fast test on the port: the
    prefix bytes persist in the port's region and pin its fast tier."""
    cfg, params = model
    PS = 4096
    store = TC.TieredStore(fast=TC.HostArrayStore(np.zeros(4 * PS, np.uint8)),
                           slow=TC.HostArrayStore(np.zeros(16 * PS, np.uint8)), extent_size=PS)
    region = TC.umap(store, config=TC.UMapConfig(page_size=PS, buffer_size=4 * PS,
                                                 num_fillers=1, num_evictors=1))
    try:
        eng = ServeEngine(cfg, params, EngineConfig(max_batch=2, page_size=4, num_pages=64,
                                                    max_pages_per_seq=16, prefill_bucket=8),
                          prefix_region=region, device="cpu")
        assert eng.paging_degraded() is False          # the region's own service, healthy
        eng.add_tenant(Tenant("gold", weight=2.0, priority=1, pin_fast=True))
        prefix = np.random.default_rng(13).integers(1, cfg.vocab_size, 16).astype(np.int32)
        key = eng.register_prefix(prefix, tenant="gold")
        assert eng._prefixes[key].pinned
        region.flush()
        assert store.tier_stats()["pinned_fast"] > 0
        np.testing.assert_array_equal(np.frombuffer(region.read(0, prefix.nbytes), np.int32),
                                      prefix)
    finally:
        TC.uunmap(region)


@pytest.mark.parametrize("tripped", [False, True])
def test_open_breaker_of_the_ports_paging_service_sheds(model, tripped):
    """``paging_degraded`` reads ``PagingService.open_breakers`` of the
    port's core: with a breaker open, a deadline that is feasible healthy
    (est 3 s < 10 s) is infeasible degraded (est 30 s) and is shed."""
    cfg, params = model
    breaker = TC.CircuitBreaker(threshold=1, reset_s=600.0)
    store = TC.ResilientStore(TC.HostArrayStore(np.zeros(8 * 4096, np.uint8)), breaker=breaker)
    region = TC.umap(store, config=TC.UMapConfig(page_size=4096, buffer_size=4 * 4096))
    try:
        if tripped:
            breaker.record_failure()
        assert region.service.open_breakers() == int(tripped)
        eng = ServeEngine(cfg, params, EngineConfig(
            max_batch=2, page_size=4, num_pages=64, max_pages_per_seq=16, prefill_bucket=8,
            est_step_s=1.0, est_prefill_s=1.0, slo_safety=1.0, degrade_multiplier=10.0),
            paging_service=region.service, device="cpu")
        assert eng.paging_degraded() is tripped
        req = Request(rid=0, max_new_tokens=2, deadline_s=10.0,
                      prompt=np.random.default_rng(23).integers(1, cfg.vocab_size, 5)
                      .astype(np.int32))
        eng.submit(req)
        eng.run_until_drained(max_steps=200)
        assert eng.stats["shed_requests"] == int(tripped)
        assert req in eng.finished and req.expired is tripped
        reg = TelemetryRegistry()
        eng.register_telemetry(registry=reg, label="d")
        fams = parse_exposition(reg.render())
        assert fams["umap_serve_paging_degraded"]["samples"][0][2] == int(tripped)
        assert fams["umap_serve_shed_total"]["samples"][0][2] == int(tripped)
    finally:
        TC.uunmap(region)
