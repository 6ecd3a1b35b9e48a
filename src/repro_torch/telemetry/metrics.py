"""Typed metric families for the telemetry substrate (DESIGN.md §15).

Three metric kinds, mirroring the Prometheus data model:

  counter     monotonically non-decreasing total (``*_total`` suffix)
  gauge       point-in-time value that can go up or down
  histogram   cumulative bucket counts + sum + count

A :class:`MetricFamily` is one named metric plus its samples (label-set →
value pairs); collectors build families on every scrape from the sources'
existing lock-free counters, so there is no write-path instrumentation
cost anywhere in the pager — the metric objects exist only for the
duration of a scrape.  :class:`HistogramState` is the one stateful
accumulator (used by the registry for scrape-duration self-telemetry).

Naming convention (enforced by :func:`validate_metric_name` and
documented in DESIGN.md §15.2):

  umap_<subsystem>_<what>[_<unit>][_total]

e.g. ``umap_pager_demand_faults_total``, ``umap_tier_resident_extents``,
``umap_process_resident_memory_bytes``.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

METRIC_KINDS = ("counter", "gauge", "histogram")

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def validate_metric_name(name: str) -> str:
    if not _METRIC_NAME_RE.match(name):
        raise ValueError(f"invalid metric name: {name!r}")
    return name


def validate_label_name(name: str) -> str:
    if not _LABEL_NAME_RE.match(name) or name.startswith("__"):
        raise ValueError(f"invalid label name: {name!r}")
    return name


def escape_label_value(value: str) -> str:
    """Escape per the Prometheus text exposition format (v0.0.4)."""
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def format_value(v) -> str:
    """Render a sample value: ints exactly, floats via ``repr`` (shortest
    round-trip), infinities in Prometheus spelling."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 2**53:
        return str(int(f))
    return repr(f)


class MetricFamily:
    """One named metric of one kind, with zero or more labeled samples.

    ``base_labels`` (usually ``{"source": <instance label>}``) are merged
    into every sample so two collector instances of the same kind can share
    one family name without colliding.
    """

    __slots__ = ("name", "kind", "help", "base_labels", "samples")

    def __init__(self, name: str, kind: str, help: str,
                 base_labels: Optional[Dict[str, str]] = None):
        if kind not in METRIC_KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = validate_metric_name(name)
        self.kind = kind
        self.help = help
        self.base_labels = dict(base_labels or {})
        for k in self.base_labels:
            validate_label_name(k)
        # (suffix, labels, value): suffix is "" except for histogram
        # component series ("_bucket", "_sum", "_count").
        self.samples: List[Tuple[str, Dict[str, str], float]] = []

    def add(self, value, **labels) -> "MetricFamily":
        merged = dict(self.base_labels)
        for k, v in labels.items():
            merged[validate_label_name(k)] = str(v)
        self.samples.append(("", merged, value))
        return self

    def add_component(self, suffix: str, value, labels: Dict[str, str]) -> None:
        """Histogram component series (``_bucket``/``_sum``/``_count``)."""
        merged = dict(self.base_labels)
        merged.update(labels)
        self.samples.append((suffix, merged, value))

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        lines.extend(render_samples(self.name, self.samples))
        return "\n".join(lines) + "\n"


def render_samples(name: str,
                   samples: Iterable[Tuple[str, Dict[str, str], float]]
                   ) -> List[str]:
    out = []
    for suffix, labels, value in samples:
        if labels:
            body = ",".join(
                f'{k}="{escape_label_value(v)}"'
                for k, v in sorted(labels.items()))
            out.append(f"{name}{suffix}{{{body}}} {format_value(value)}")
        else:
            out.append(f"{name}{suffix} {format_value(value)}")
    return out


def counter(name: str, help: str,
            base_labels: Optional[Dict[str, str]] = None) -> MetricFamily:
    return MetricFamily(name, "counter", help, base_labels)


def gauge(name: str, help: str,
          base_labels: Optional[Dict[str, str]] = None) -> MetricFamily:
    return MetricFamily(name, "gauge", help, base_labels)


# Default buckets for sub-second operational latencies (scrape durations).
DEFAULT_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0)


class HistogramState:
    """A live cumulative histogram accumulator (thread-safe).

    The only stateful metric primitive: collectors derive counters/gauges
    from source counters on demand, but durations must be observed as they
    happen.  The internal lock is private to telemetry — it is never one
    of the pager's shard locks, so holding it cannot block a fill.
    """

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = bs
        self._counts = [0] * len(bs)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._count += 1
            for i, b in enumerate(self.bounds):
                if value <= b:
                    self._counts[i] += 1

    def to_family(self, name: str, help: str,
                  base_labels: Optional[Dict[str, str]] = None) -> MetricFamily:
        fam = MetricFamily(name, "histogram", help, base_labels)
        with self._lock:
            counts = list(self._counts)
            total, sm = self._count, self._sum
        # observe() increments every bucket whose bound covers the value,
        # so the per-bucket counts are already cumulative.
        for b, c in zip(self.bounds, counts):
            fam.add_component("_bucket", c, {"le": format_value(b)})
        fam.add_component("_bucket", total, {"le": "+Inf"})
        fam.add_component("_sum", sm, {})
        fam.add_component("_count", total, {})
        return fam
