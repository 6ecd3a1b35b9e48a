"""Serve collector: serving-engine, paged-KV-cache, and weight-pager
counters.

All three sources are optional (duck-typed):

  engine        a ``ServeEngine`` — its ``stats`` dict plus admission/
                occupancy gauges read from plain attributes (the engine
                loop is single-threaded; reads are GIL-atomic)
  kv            a ``PagedKVCache`` — pool occupancy + host-lock telemetry
  weight_pager  a ``LayerWeightPager`` — layer fill/hit/steal counters
"""

from __future__ import annotations

from typing import List

from ..metrics import MetricFamily
from .base import Collector

_ENGINE_COUNTERS = (
    ("steps", "umap_serve_steps_total", "Decode iterations executed"),
    ("prefills", "umap_serve_prefills_total", "Requests prefilled into the pool"),
    ("evictions", "umap_serve_evictions_total",
     "Sequences evicted (uunmap analogue)"),
    ("requeues", "umap_serve_requeues_total",
     "Evicted requests re-queued for restart"),
    ("admission_pauses", "umap_serve_admission_pauses_total",
     "High-watermark admission pauses (global + per-tenant gates)"),
    ("slo_deferrals", "umap_serve_slo_deferrals_total",
     "Admissions deferred for insufficient deadline headroom"),
    ("slo_misses", "umap_serve_slo_misses_total",
     "Requests finished past their deadline"),
    ("expired", "umap_serve_expired_total",
     "Requests abandoned after max_restarts requeues"),
    ("victim_evictions", "umap_serve_victim_evictions_total",
     "Sequences evicted as reclaim victims under pool pressure"),
    ("cow_copies", "umap_serve_cow_copies_total",
     "Copy-on-write page copies (shared prefix divergence)"),
    ("shared_pages_mapped", "umap_serve_shared_pages_mapped_total",
     "Prefix pages mapped into requests without copying"),
    ("prefix_hits", "umap_serve_prefix_hits_total",
     "Admissions that matched a registered prompt prefix"),
    ("prefix_drops", "umap_serve_prefix_drops_total",
     "Registered prefixes dropped (reclaim or explicit)"),
    ("shed_requests", "umap_serve_shed_total",
     "Requests shed at admission under degraded paging (DESIGN.md §17.9)"),
)

#: per-tenant stats keys exported with a ``tenant`` label (DESIGN.md §16.6);
#: each engine aggregate above that has a per-tenant breakdown appears here.
_TENANT_COUNTERS = (
    ("prefills", "umap_serve_tenant_prefills_total",
     "Per-tenant requests prefilled"),
    ("evictions", "umap_serve_tenant_evictions_total",
     "Per-tenant sequences evicted"),
    ("requeues", "umap_serve_tenant_requeues_total",
     "Per-tenant requeues"),
    ("admission_pauses", "umap_serve_tenant_admission_pauses_total",
     "Per-tenant fair-share watermark pauses"),
    ("slo_deferrals", "umap_serve_tenant_slo_deferrals_total",
     "Per-tenant SLO admission deferrals"),
    ("slo_misses", "umap_serve_tenant_slo_misses_total",
     "Per-tenant deadline misses"),
    ("expired", "umap_serve_tenant_expired_total",
     "Per-tenant expired requests"),
    ("shed_requests", "umap_serve_tenant_shed_requests_total",
     "Per-tenant requests shed under degraded paging"),
    ("finished", "umap_serve_tenant_finished_total",
     "Per-tenant retired requests"),
    ("tokens_generated", "umap_serve_tenant_tokens_generated_total",
     "Per-tenant decoded tokens"),
)

_KV_GAUGES = (
    ("pages_used", "umap_kv_pages_used", "Device pool pages in use"),
    ("pages_free", "umap_kv_pages_free", "Device pool pages free"),
    ("occupancy", "umap_kv_occupancy_ratio", "Device pool occupancy [0,1]"),
    ("sequences", "umap_kv_sequences", "Live sequences in the cache"),
    ("page_bytes", "umap_kv_page_size_bytes", "Bytes per KV page (K+V)"),
)

_WEIGHT_COUNTERS = (
    ("fills", "umap_weight_fills_total", "Layers fetched host-to-device"),
    ("hits", "umap_weight_hits_total", "Layer requests served from a slot"),
    ("waits", "umap_weight_waits_total",
     "Layer requests that waited on an in-flight fetch"),
    ("evictions", "umap_weight_evictions_total",
     "Layers dropped from the device slot ring"),
    ("pattern_transitions", "umap_weight_pattern_transitions_total",
     "Adaptive readahead retunes"),
    ("steals", "umap_weight_steals_total",
     "Weight-pager filler work-steal events"),
)


class ServeCollector(Collector):
    kind = "serve"

    def __init__(self, engine=None, kv=None, weight_pager=None, label=None):
        super().__init__(label)
        self.engine = engine
        self.kv = kv
        self.weight_pager = weight_pager

    def collect(self) -> List[MetricFamily]:
        fams: List[MetricFamily] = []
        if self.engine is not None:
            eng = self.engine
            st = dict(eng.stats)
            fams += [self.c1(m, h, st.get(k, 0))
                     for k, m, h in _ENGINE_COUNTERS]
            fams += [
                self.g1("umap_serve_active_requests",
                        "Requests currently decoding", len(eng.active)),
                self.g1("umap_serve_waiting_requests",
                        "Requests queued for admission", len(eng.waiting)),
                self.c1("umap_serve_finished_requests_total",
                        "Requests retired", len(eng.finished)),
                self.g1("umap_serve_pool_occupancy_ratio",
                        "KV page-pool occupancy [0,1]",
                        eng.allocator.occupancy()),
                self.g1("umap_serve_peak_pages_used",
                        "High-water mark of pool pages in use",
                        st.get("peak_pages_used", 0)),
                self.g1("umap_serve_tenants",
                        "Registered tenants", len(getattr(eng, "tenants", ()))),
                self.g1("umap_serve_paging_degraded",
                        "1 while any paging-store circuit breaker is OPEN",
                        int(getattr(eng, "paging_degraded", bool)())),
            ]
            per_tenant = st.get("per_tenant") or {}
            if per_tenant:
                for key, name, help_ in _TENANT_COUNTERS:
                    fam = self.counter(name, help_)
                    for tenant in sorted(per_tenant):
                        fam.add(per_tenant[tenant].get(key, 0), tenant=tenant)
                    fams.append(fam)
        if self.kv is not None:
            st = self.kv.stats()
            fams += [self.g1(m, h, st[k]) for k, m, h in _KV_GAUGES]
            fams += [
                self.c1("umap_kv_auto_evicted_pages_total",
                        "Window-prefix pages auto-evicted", st["auto_evicted_pages"]),
                self.c1("umap_kv_host_lock_contended_total",
                        "Contended KV host-metadata lock acquisitions",
                        st["host_lock_contended"]),
                self.c1("umap_kv_cow_copies_total",
                        "Copy-on-write page copies in the KV pool",
                        st.get("cow_copies", 0)),
                self.g1("umap_kv_shared_pages",
                        "Physical pages currently mapped by >1 sequence",
                        st.get("shared_pages", 0)),
                self.c1("umap_kv_shared_pages_mapped_total",
                        "Prefix pages mapped without copying",
                        st.get("shared_pages_mapped", 0)),
            ]
            phases = self.gauge(
                "umap_kv_sequences_by_phase",
                "Live sequences per detected access-pattern phase")
            counts: dict = {}
            for phase in st["phases"].values():
                counts[phase] = counts.get(phase, 0) + 1
            for phase, n in sorted(counts.items()):
                phases.add(n, phase=phase)
            fams.append(phases)
        if self.weight_pager is not None:
            wp = self.weight_pager
            st = dict(wp.stats)
            fams += [self.c1(m, h, st.get(k, 0))
                     for k, m, h in _WEIGHT_COUNTERS]
            fams.append(self.g1("umap_weight_slots",
                                "Device slot-ring capacity", wp.num_slots))
        return fams
