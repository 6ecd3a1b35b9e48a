"""Pager collector: one ``PagingService``'s counters as metric families.

Samples the service's lock-free aggregation path only —
``service.stats`` reads per-shard counter dicts without taking any shard
lock (int reads are GIL-consistent), so a scrape can never block a fill,
an eviction, or a faulting application thread (DESIGN.md §15.3).  The
per-shard detail rides ``shard`` labels; per-filler fills ride ``filler``
labels.
"""

from __future__ import annotations

from typing import List

from ..metrics import MetricFamily
from .base import Collector

# (stats key, metric name, help) for the flat service-wide counters.
_COUNTERS = (
    ("demand_faults", "umap_pager_demand_faults_total",
     "Demand faults that required a store fill"),
    ("page_hits", "umap_pager_page_hits_total",
     "Touches that found the page PRESENT"),
    ("wait_hits", "umap_pager_wait_hits_total",
     "Touches that waited on an in-flight fill"),
    ("prefetch_fills", "umap_pager_prefetch_fills_total",
     "Pages installed by prefetch/readahead"),
    ("prefetch_hits", "umap_pager_prefetch_hits_total",
     "Prefetched pages later touched"),
    ("evictions", "umap_pager_evictions_total",
     "Pages evicted from the buffer"),
    ("writebacks", "umap_pager_writebacks_total",
     "Dirty pages written back to their store"),
    ("watermark_flushes", "umap_pager_watermark_flushes_total",
     "Flush batches posted by the watermark monitor"),
    ("coalesced_fills", "umap_pager_coalesced_fills_total",
     "Batched fill operations (>= 2 pages each)"),
    ("coalesced_pages", "umap_pager_coalesced_pages_total",
     "Pages installed via batched fills"),
    ("coalesced_writebacks", "umap_pager_coalesced_writebacks_total",
     "Batched write-back operations (>= 2 pages each)"),
    ("writeback_pages", "umap_pager_writeback_pages_total",
     "Pages written via batched write-backs"),
    ("fill_stalls", "umap_pager_fill_stalls_total",
     "Fills that waited on cleaner backpressure"),
    ("lock_contended", "umap_pager_lock_contended_total",
     "Shard-lock acquisitions that had to wait"),
    ("steals", "umap_pager_steals_total",
     "Work-stealing events (idle filler stole a batch)"),
    ("stolen_work", "umap_pager_stolen_work_total",
     "Fill work items moved by stealing"),
    ("io_errors", "umap_pager_io_errors_total",
     "Fills that died on a backing-store exception"),
    ("writeback_errors", "umap_pager_writeback_errors_total",
     "Failed write-back attempts (incl. retries)"),
    ("quarantine_retries", "umap_pager_quarantine_retries_total",
     "Quarantined pages re-posted for cleaning with a fresh retry budget"),
    ("pattern_transitions", "umap_pager_pattern_transitions_total",
     "Classifier-driven retunes applied"),
    ("tier_promotions", "umap_pager_tier_promotions_total",
     "Extents migrated into the fast tier"),
    ("tier_demotions", "umap_pager_tier_demotions_total",
     "Extents migrated out of the fast tier"),
    ("tier_errors", "umap_pager_tier_errors_total",
     "Tier-migration cycles that died on store I/O"),
    ("tier_cycles", "umap_pager_tier_cycles_total",
     "Tier-migration engine passes completed"),
)

# Shard-counter keys broken out per shard (the acceptance signals:
# contention, faults, stalls, quarantine per stripe).
_PER_SHARD = (
    ("demand_faults", "umap_pager_shard_demand_faults_total",
     "Demand faults per metadata shard"),
    ("lock_contended", "umap_pager_shard_lock_contended_total",
     "Contended lock acquisitions per metadata shard"),
    ("fill_stalls", "umap_pager_shard_fill_stalls_total",
     "Backpressure stalls per metadata shard"),
    ("quarantined_pages", "umap_pager_shard_quarantined_pages",
     "Currently quarantined pages per metadata shard"),
)


class PagerCollector(Collector):
    kind = "pager"

    def __init__(self, service, label=None):
        super().__init__(label)
        self.service = service

    def collect(self) -> List[MetricFamily]:
        svc = self.service
        snap = svc.stats.snapshot()          # lock-free aggregation path
        fams = [self.c1(mname, help_, snap[key])
                for key, mname, help_ in _COUNTERS]
        for key, mname, help_ in _PER_SHARD:
            # quarantined_pages can fall again on re-post (§17.4): gauge.
            mk = self.gauge if key == "quarantined_pages" else self.counter
            fam = mk(mname, help_)
            for i, shard in enumerate(snap["per_shard"]):
                fam.add(shard[key], shard=i)
            fams.append(fam)
        fills = self.counter("umap_pager_filler_fills_total",
                             "Pages filled per filler thread")
        for worker, n in sorted(snap["per_filler_fills"].items()):
            fills.add(n, filler=worker)
        fams.append(fills)
        fams.extend([
            self.g1("umap_pager_shards", "Metadata shard (stripe) count",
                    snap["shards"]),
            self.g1("umap_pager_fill_queue_peak",
                    "High-water mark of queued fill work", snap["fill_queue_peak"]),
            self.g1("umap_pager_dirty_ratio",
                    "Dirty pages / buffer slots", svc.dirty_ratio()),
            self.g1("umap_pager_quarantined_pages",
                    "Pages currently quarantined (write-back retries "
                    "exhausted, awaiting retry_quarantined)",
                    snap["quarantined_pages"]),
            self.g1("umap_pager_buffer_slots",
                    "Page-buffer slot count", svc.buffer.num_slots),
            self.g1("umap_pager_page_size_bytes",
                    "Configured UMap page size", svc.config.page_size),
        ])
        return fams
