"""Modular metric collectors (DESIGN.md §15.1).

One small collector per subsystem, each with its own test class
(tests/test_telemetry.py) — the omnistat shape.  Collectors duck-type
their sources, so this package has no imports from ``repro_torch.core`` /
``repro_torch.serve`` and the core can lazy-import telemetry cycle-free.
"""

from .base import Collector
from .leases import LeaseCollector
from .pager import PagerCollector
from .process import ProcessCollector
from .resilience import ResilienceCollector
from .serve import ServeCollector
from .tiering import TieringCollector
from .train import TrainCollector

__all__ = [
    "Collector",
    "LeaseCollector",
    "PagerCollector",
    "ProcessCollector",
    "ResilienceCollector",
    "ServeCollector",
    "TieringCollector",
    "TrainCollector",
]
