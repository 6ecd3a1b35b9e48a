"""Resilience collector: one ``ResilientStore``'s retry / hedge / breaker /
checksum counters as metric families (DESIGN.md §17.8).

Samples ``store.resilience_stats()`` only — the wrapper's own counter lock
plus GIL-atomic breaker state reads; a scrape never touches the inner store
or any pager lock, so it can never block (or be blocked by) in-flight I/O,
including I/O currently failing against a dead tier.
"""

from __future__ import annotations

from typing import List

from ..metrics import MetricFamily
from .base import Collector

# (resilience_stats key, metric name, help) — monotonic counters.
_COUNTERS = (
    ("retries", "umap_resilience_retries_total",
     "Retry attempts after a transient store failure"),
    ("retries_ok", "umap_resilience_retries_ok_total",
     "Ops that succeeded after at least one retry"),
    ("exhausted", "umap_resilience_retry_exhausted_total",
     "Ops that failed after exhausting the retry budget/deadline"),
    ("deadline_exceeded", "umap_resilience_deadline_exceeded_total",
     "Ops abandoned because the per-op deadline expired"),
    ("permanent_errors", "umap_resilience_permanent_errors_total",
     "Ops failed on a permanent (non-retriable) error"),
    ("breaker_rejections", "umap_resilience_breaker_rejections_total",
     "Ops rejected fail-fast by an open circuit breaker"),
    ("hedges", "umap_resilience_hedges_total",
     "Hedged (duplicate) reads issued past the hedge delay"),
    ("hedge_wins", "umap_resilience_hedge_wins_total",
     "Hedged reads where the duplicate finished first"),
    ("checksum_failures", "umap_resilience_checksum_failures_total",
     "Reads whose CRC did not match the last known good block checksum"),
    ("breaker_opens", "umap_resilience_breaker_opens_total",
     "Breaker transitions into OPEN (tier declared unhealthy)"),
    ("breaker_half_opens", "umap_resilience_breaker_half_opens_total",
     "Breaker transitions into HALF_OPEN (health probing)"),
    ("breaker_closes", "umap_resilience_breaker_closes_total",
     "Breaker transitions back to CLOSED (tier recovered)"),
)

# (resilience_stats key, metric name, help) — gauges.
_GAUGES = (
    ("breaker_state", "umap_resilience_breaker_state",
     "Circuit breaker state: 0 closed, 1 half-open, 2 open"),
    ("degraded_seconds", "umap_resilience_degraded_seconds",
     "Cumulative seconds this store's breaker has spent OPEN"),
)


class ResilienceCollector(Collector):
    kind = "resilience"

    def __init__(self, store, label=None):
        super().__init__(label)
        self.store = store

    def collect(self) -> List[MetricFamily]:
        snap = self.store.resilience_stats()
        fams = [self.c1(mname, help_, snap[key])
                for key, mname, help_ in _COUNTERS]
        fams.extend(self.g1(mname, help_, snap[key])
                    for key, mname, help_ in _GAUGES)
        return fams
