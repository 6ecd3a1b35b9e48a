"""Collector base class (omnistat-style modular collectors).

Each collector wraps ONE source object (a ``PagingService``, a
``TieredStore``, a serving engine, …) purely by duck-typing — the
telemetry package imports nothing from the core, so the core can
lazy-import telemetry without a cycle.  A collector owns:

  * ``kind``   — its metric-family namespace ("pager", "tiering", …)
  * ``label``  — instance identity, emitted as the ``source`` label on
                 every sample so several instances of one kind can share
                 family names
  * ``collect()`` — build that scrape's families from the source's
                 existing lock-free stats paths.  No state is kept
                 between scrapes; zero overhead when never scraped.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

from ..metrics import MetricFamily

_ids = itertools.count()


class Collector:
    kind = "base"

    def __init__(self, label: Optional[str] = None):
        self.label = label if label is not None else f"{self.kind}{next(_ids)}"

    @property
    def name(self) -> str:
        return f"{self.kind}:{self.label}"

    @property
    def base_labels(self) -> Dict[str, str]:
        return {"source": self.label}

    def collect(self) -> List[MetricFamily]:
        raise NotImplementedError

    # ------------------------------------------------------------ helpers

    def counter(self, name: str, help: str) -> MetricFamily:
        return MetricFamily(name, "counter", help, self.base_labels)

    def gauge(self, name: str, help: str) -> MetricFamily:
        return MetricFamily(name, "gauge", help, self.base_labels)

    def c1(self, name: str, help: str, value) -> MetricFamily:
        """One-sample counter family."""
        return self.counter(name, help).add(value)

    def g1(self, name: str, help: str, value) -> MetricFamily:
        """One-sample gauge family."""
        return self.gauge(name, help).add(value)
