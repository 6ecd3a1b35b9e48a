"""Production telemetry: collectors, registry, Prometheus exporter.

The observability substrate (ROADMAP "production observability",
DESIGN.md §15): per-subsystem collectors sample the pager's existing
lock-free stats paths into typed metric families, a registry merges
them, and a lightweight HTTP exporter serves Prometheus text format.

Quickstart (programmatic)::

    from repro_torch import telemetry
    service.register_telemetry()            # pager + lease collectors
    store.register_telemetry()              # TieredStore residency
    exp = telemetry.TelemetryExporter(port=9100).start()
    ...
    exp.close()

Quickstart (env, zero code)::

    UMAP_TELEMETRY_PORT=9100 python my_app.py
    curl localhost:9100/metrics

With the env var set, every ``PagingService`` self-registers at
construction and one shared exporter is started on first use; unset
(the default), nothing is registered, started, or sampled — zero
overhead.  Scrapes never take pager shard locks (DESIGN.md §15.3).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from .collectors import (
    Collector,
    LeaseCollector,
    PagerCollector,
    ProcessCollector,
    ServeCollector,
    TieringCollector,
)
from .exporter import DEFAULT_HOST, TelemetryExporter
from .metrics import (
    HistogramState,
    MetricFamily,
    counter,
    gauge,
)
from .registry import CONTENT_TYPE, TelemetryRegistry, default_registry

__all__ = [
    "CONTENT_TYPE",
    "Collector",
    "HistogramState",
    "LeaseCollector",
    "MetricFamily",
    "PagerCollector",
    "ProcessCollector",
    "ServeCollector",
    "TelemetryExporter",
    "TelemetryRegistry",
    "TieringCollector",
    "counter",
    "default_registry",
    "env_port",
    "env_exporter",
    "gauge",
    "shutdown",
    "start_from_env",
]

_env_lock = threading.Lock()
_env_exporter: Optional[TelemetryExporter] = None
_env_process_registered = False


def env_port(env: Optional[dict] = None) -> int:
    """The UMAP_TELEMETRY_PORT setting; 0 means disabled (the default)."""
    env = os.environ if env is None else env
    raw = str(env.get("UMAP_TELEMETRY_PORT", "") or "").strip()
    try:
        return int(raw) if raw else 0
    except ValueError:
        return 0


def start_from_env(env: Optional[dict] = None) -> Optional[TelemetryExporter]:
    """Start (once) the process-wide exporter if UMAP_TELEMETRY_PORT is set.

    Idempotent and thread-safe: concurrent services constructed with the
    env var set share one exporter over the default registry.  Returns the
    exporter, or None when telemetry is disabled.  A process collector is
    registered alongside the first start.
    """
    global _env_exporter, _env_process_registered
    port = env_port(env)
    if port <= 0:
        return None
    env = os.environ if env is None else env
    host = str(env.get("UMAP_TELEMETRY_HOST", "") or "").strip() or DEFAULT_HOST
    with _env_lock:
        if _env_exporter is None:
            reg = default_registry()
            if not _env_process_registered:
                reg.register(ProcessCollector(label="self"))
                _env_process_registered = True
            _env_exporter = TelemetryExporter(
                registry=reg, port=port, host=host).start()
        return _env_exporter


def env_exporter() -> Optional[TelemetryExporter]:
    """The exporter started by :func:`start_from_env`, if any."""
    return _env_exporter


def shutdown() -> None:
    """Stop the env-started exporter (test harness / clean shutdown)."""
    global _env_exporter
    with _env_lock:
        exp, _env_exporter = _env_exporter, None
    if exp is not None:
        exp.close()
