"""Collector registry: the one place a scrape talks to (DESIGN.md §15).

A :class:`TelemetryRegistry` holds named collectors; ``render()`` walks
them, merges families that share a name (two pager collectors for two
services contribute samples to ONE ``umap_pager_demand_faults_total``
block, distinguished by their ``source`` label), and emits Prometheus
text-format v0.0.4.

Scrape-path rules (DESIGN.md §15.3):

  * A scrape must never take a pager shard lock — collectors read only
    the existing lock-free aggregation paths (``PagingService.stats``,
    relaxed ``tier_stats``).  The registry's own lock guards the
    collector *list*, is held only to copy it, and is never held while
    collectors run.
  * A misbehaving collector cannot kill a scrape: its exception is
    swallowed and counted in ``umap_telemetry_collect_errors_total``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from .metrics import HistogramState, MetricFamily, render_samples

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class TelemetryRegistry:
    def __init__(self):
        self._lock = threading.Lock()          # collector list only
        self._collectors: Dict[str, object] = {}
        self._scrapes = 0
        self._collect_errors: Dict[str, int] = {}
        self._scrape_hist = HistogramState()

    # ------------------------------------------------------------ membership

    def register(self, collector, name: Optional[str] = None) -> str:
        """Add a collector; returns the (de-duplicated) registry name."""
        base = name or getattr(collector, "name", None) \
            or type(collector).__name__
        with self._lock:
            final = base
            n = 2
            while final in self._collectors:
                final = f"{base}#{n}"
                n += 1
            self._collectors[final] = collector
        return final

    def unregister(self, name: str) -> bool:
        with self._lock:
            return self._collectors.pop(name, None) is not None

    def collector_names(self) -> List[str]:
        with self._lock:
            return list(self._collectors)

    def clear(self) -> None:
        with self._lock:
            self._collectors.clear()

    # --------------------------------------------------------------- scraping

    def collect(self) -> List[MetricFamily]:
        """Run every collector; failures are counted, never propagated."""
        return self._collect_collectors() + self._self_families()

    def _collect_collectors(self) -> List[MetricFamily]:
        with self._lock:
            items = list(self._collectors.items())
        fams: List[MetricFamily] = []
        for cname, collector in items:
            try:
                fams.extend(collector.collect())
            except Exception:
                # Single-writer-per-key under the GIL (scrapes may overlap,
                # but a lost increment only undercounts telemetry errors).
                self._collect_errors[cname] = \
                    self._collect_errors.get(cname, 0) + 1
        return fams

    def _self_families(self) -> List[MetricFamily]:
        scrapes = MetricFamily(
            "umap_telemetry_scrapes_total", "counter",
            "Scrapes served by this registry")
        scrapes.add(self._scrapes)
        errors = MetricFamily(
            "umap_telemetry_collect_errors_total", "counter",
            "Collector invocations that raised (per collector)")
        for cname, n in sorted(self._collect_errors.items()):
            errors.add(n, collector=cname)
        if not self._collect_errors:
            errors.add(0, collector="none")
        hist = self._scrape_hist.to_family(
            "umap_telemetry_scrape_duration_seconds",
            "Wall time spent building one /metrics response")
        return [scrapes, errors, hist]

    def render(self) -> str:
        """One Prometheus text-format payload (merged per family name)."""
        t0 = time.perf_counter()
        self._scrapes += 1
        merged: Dict[str, tuple] = {}        # name -> (kind, help, samples)
        order: List[str] = []
        for fam in self._collect_collectors():
            if fam.name not in merged:
                merged[fam.name] = (fam.kind, fam.help, list(fam.samples))
                order.append(fam.name)
            else:
                kind, help_, samples = merged[fam.name]
                if kind != fam.kind:
                    # Same name, different kind: a collector bug.  Keep the
                    # first registration; count it like a collect error.
                    self._collect_errors["type-conflict:" + fam.name] = \
                        self._collect_errors.get(
                            "type-conflict:" + fam.name, 0) + 1
                    continue
                samples.extend(fam.samples)
        # Self-telemetry last: conflicts counted above are visible in the
        # SAME scrape, and these names cannot collide with collectors'.
        for fam in self._self_families():
            merged[fam.name] = (fam.kind, fam.help, list(fam.samples))
            order.append(fam.name)
        lines: List[str] = []
        for name in order:
            kind, help_, samples = merged[name]
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            lines.extend(render_samples(name, samples))
        self._scrape_hist.observe(time.perf_counter() - t0)
        return "\n".join(lines) + "\n"


_default_lock = threading.Lock()
_default: Optional[TelemetryRegistry] = None


def default_registry() -> TelemetryRegistry:
    """Process-wide registry used by the ``register_telemetry`` opt-ins and
    the env-driven exporter."""
    global _default
    with _default_lock:
        if _default is None:
            _default = TelemetryRegistry()
        return _default
