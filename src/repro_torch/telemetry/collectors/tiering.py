"""Tiering collector: one ``TierChain``'s residency + migration counters.

Samples ``store.tier_stats(relaxed=True)`` — the relaxed mode reads the
store's counters and map sizes without taking its routing lock, so a
scrape cannot queue behind an in-flight promote/demote staging copy
(DESIGN.md §15.3).  The values are individually GIL-consistent but not a
consistent cross-field cut, same contract as ``ServiceStats.snapshot()``.

Per-level state is emitted as ONE family per metric with a ``tier``
label (``tier="0"`` is the fastest cache, the highest index the base
tier), so a dashboard written against a two-tier deployment keeps
working unchanged when the chain grows a middle level.  The sampled
per-op latency EWMAs and the engine's aggregate placement utility
(DESIGN.md §14.3/§14.5) are exported the same way.
"""

from __future__ import annotations

from typing import List

from ..metrics import MetricFamily
from .base import Collector

# stats-list key -> one family, one sample per chain level (tier label)
_LEVEL_GAUGES = (
    ("resident_by_level", "umap_tier_resident_extents",
     "Extents with a valid copy at this chain level"),
    ("free_by_level", "umap_tier_free_slots",
     "Unoccupied extent slots at this chain level"),
    ("slots_by_level", "umap_tier_slots",
     "Total extent slots at this chain level"),
    ("utility_by_level", "umap_tier_utility",
     "Aggregate placement utility the migration engine computed for the "
     "extents resident at this chain level"),
)

_LEVEL_COUNTERS = (
    ("read_bytes_by_level", "umap_tier_read_bytes_total",
     "Bytes served by this chain level"),
    ("promotions_by_level", "umap_tier_promotions_total",
     "Extents copied into this chain level"),
    ("demotions_by_level", "umap_tier_demotions_total",
     "Extent copies dropped from this chain level"),
    ("migration_write_bytes_by_level", "umap_tier_migration_write_bytes_total",
     "Migration staging bytes written into this chain level"),
)

_GAUGES = (
    ("dirty_extents", "umap_tier_dirty_extents",
     "Extents whose newest copy lives in a cache level (base stale)"),
    ("pinned_fast", "umap_tier_pinned_fast_extents",
     "Extents pinned to a chain level by application hint"),
    ("levels", "umap_tier_levels",
     "Chain depth (cache levels plus the base tier)"),
)

_COUNTERS = (
    ("migration_aborts", "umap_tier_migration_aborts_total",
     "Promote/demote transactions aborted by a racing write/pin"),
    ("shadow_demotions", "umap_tier_shadow_demotions_total",
     "Demotions satisfied by a residency flip (no write-back, §14.2)"),
    ("tier_failovers", "umap_tier_failovers_total",
     "Reads rerouted or residency dropped around a tripped level"),
)


class TieringCollector(Collector):
    kind = "tiering"

    def __init__(self, store, label=None):
        super().__init__(label)
        self.store = store

    def _per_level(self, name: str, help: str, kind: str,
                   values) -> MetricFamily:
        fam = MetricFamily(name, kind, help, self.base_labels)
        for lvl, v in enumerate(values):
            fam.add(v, tier=lvl)
        return fam

    def collect(self) -> List[MetricFamily]:
        st = self.store
        stats = st.tier_stats(relaxed=True)
        fams = [self._per_level(m, h, "gauge", stats[k])
                for k, m, h in _LEVEL_GAUGES]
        fams += [self._per_level(m, h, "counter", stats[k])
                 for k, m, h in _LEVEL_COUNTERS]
        lat = self.gauge("umap_tier_latency_seconds",
                         "Sampled per-operation latency EWMA of this chain "
                         "level (0 until first observed op, §14.3)")
        for lvl, v in enumerate(stats["latency_read_s"]):
            lat.add(v, tier=lvl, op="read")
        for lvl, v in enumerate(stats["latency_write_s"]):
            lat.add(v, tier=lvl, op="write")
        fams.append(lat)
        fams += [self.g1(m, h, stats[k]) for k, m, h in _GAUGES]
        fams += [self.c1(m, h, stats[k]) for k, m, h in _COUNTERS]
        fams.append(self.g1("umap_tier_extent_size_bytes",
                            "Migration extent size", st.extent_size))
        return fams
