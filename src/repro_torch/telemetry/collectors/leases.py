"""Lease collector: zero-copy lease activity (DESIGN.md §13) across the
lease-granting surfaces.

Sources are all optional — pass whichever exist in the process:

  service        a ``PagingService`` (lease grants / blocked evictions,
                 via the lock-free ``stats`` aggregation)
  kv             a ``PagedKVCache`` (``lease_kv`` grants, pinned
                 sequences; ``stats()`` takes the KV host-metadata lock,
                 which is never held across store I/O — documented
                 exception to the no-locks scrape rule)
  weight_source  a ``RegionLayerSource`` (staging-copy fallbacks — a
                 nonzero rate means the zero-copy path is disabled)
"""

from __future__ import annotations

from typing import List

from ..metrics import MetricFamily
from .base import Collector


class LeaseCollector(Collector):
    kind = "leases"

    def __init__(self, service=None, kv=None, weight_source=None, label=None):
        super().__init__(label)
        self.service = service
        self.kv = kv
        self.weight_source = weight_source

    def collect(self) -> List[MetricFamily]:
        fams: List[MetricFamily] = []
        if self.service is not None:
            snap = self.service.stats.snapshot()
            fams += [
                self.c1("umap_leases_granted_total",
                        "Zero-copy page leases granted", snap["leases"]),
                self.c1("umap_leases_blocked_evictions_total",
                        "Victim/clean skips due to live leases",
                        snap["lease_blocked_evictions"]),
            ]
        if self.kv is not None:
            st = self.kv.stats()
            fams += [
                self.c1("umap_kv_leases_granted_total",
                        "lease_kv() grants on the paged KV cache",
                        st["leases"]),
                self.c1("umap_kv_lease_blocked_evictions_total",
                        "KV window evictions refused by a live lease",
                        st["lease_blocked_evictions"]),
                self.g1("umap_kv_leased_sequences",
                        "Sequences currently pinned by a lease",
                        st["leased_sequences"]),
            ]
        if self.weight_source is not None:
            fams.append(self.c1(
                "umap_weight_staging_copies_total",
                "Weight pages fetched via the copy-backed fallback "
                "(0 on the zero-copy path)",
                self.weight_source.staging_copies))
        return fams
