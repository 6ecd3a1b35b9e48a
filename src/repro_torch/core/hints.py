"""Application hints: access advisors + page-size advisor (paper §3.6).

The paper's argument is that the *application* knows its access pattern and
should drive prefetching and page-size selection.  This module packages the
hint vocabulary:

  * :class:`AccessAdvice` — madvise-style per-region advice that maps to a
    concrete (readahead, eviction-policy) setting.
  * :func:`advice_for_phase` / :func:`phase_for_advice` — the bridge between
    this *static* vocabulary and the *online* phase vocabulary of
    :mod:`repro_torch.core.pattern` (the adaptive engine speaks ``Phase``, the
    application speaks ``AccessAdvice``; both resolve to the same settings).
  * :func:`plan_prefetch` — turn an application-supplied iterator of future
    offsets into page sets, deduplicated and windowed, for
    ``region.prefetch_pages`` (irregular patterns welcome — §3.6: "UMap could
    prefetch a set of arbitrary pages into memory").
  * :class:`PageSizeAdvisor` — the napkin model behind the paper's page-size
    sweeps: given a store's latency/bandwidth and the workload's expected
    useful fraction per page, estimate time-per-useful-byte and recommend a
    page size.  (Benchmarks sweep real page sizes; the advisor documents the
    reasoning and provides a starting point.)

Static-hint vs. online-classifier precedence (DESIGN.md §8): a region that
received explicit advice — ``readahead_pages=`` at construction or
:meth:`UMapRegion.advise` at runtime — is *hint-pinned* and the adaptive
classifier never retunes it.  The classifier only drives regions that gave
no hint.  Application knowledge outranks inference, always.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Iterable, List, Sequence

from .config import UMapConfig
from .pattern import Phase


class AccessAdvice(enum.Enum):
    """madvise-style per-region access declarations (paper §3.6).

    Each member maps (via :data:`ADVICE_SETTINGS`) to a concrete
    ``(read_ahead, eviction_policy)`` pair; :func:`apply_advice` bakes it
    into a config, :meth:`UMapRegion.advise` applies it to a live region and
    pins it against the online classifier.
    """

    NORMAL = "normal"
    SEQUENTIAL = "sequential"   # deep readahead, forward-moving eviction
    RANDOM = "random"           # no readahead, LRU
    WILLNEED = "willneed"       # caller will prefetch explicitly
    STREAMING = "streaming"     # sequential + evict-behind (no reuse)
    STRIDED = "strided"         # constant non-unit stride (classifier bridge)


ADVICE_SETTINGS = {
    AccessAdvice.NORMAL: dict(read_ahead=0, eviction_policy="lru"),
    AccessAdvice.SEQUENTIAL: dict(read_ahead=8, eviction_policy="lru"),
    AccessAdvice.RANDOM: dict(read_ahead=0, eviction_policy="lru"),
    AccessAdvice.WILLNEED: dict(read_ahead=0, eviction_policy="lru"),
    AccessAdvice.STREAMING: dict(read_ahead=16, eviction_policy="swa"),
    AccessAdvice.STRIDED: dict(read_ahead=4, eviction_policy="lru"),
}


class TierHint(enum.Enum):
    """Tier-placement hints for ``TieredStore``-backed regions (§14.3).

    The migration engine normally ranks extents by decayed demand-fault
    heat; these hints let the application override that inference for a
    byte range (``region.advise(tier_hint=..., offset=, nbytes=)``):

      HOT       seed the range with promote-threshold heat — migrate it to
                the fast tier ahead of observed demand (e.g. the partition
                about to be sorted).
      COLD      zero the range's heat and queue demotion — reclaim fast-
                tier slots from data the app knows it is done with.
      PIN_FAST  promote at top priority AND pin: demotion refuses pinned
                extents, so the range stays fast-tier-resident under any
                pressure (e.g. embedding tables every request touches).

    Constructible from the plain strings ``"hot"`` / ``"cold"`` /
    ``"pin_fast"`` — ``TierHint("hot") is TierHint.HOT``.
    """

    HOT = "hot"
    COLD = "cold"
    PIN_FAST = "pin_fast"


def parse_tier_hint(value) -> "tuple[TierHint, int | None]":
    """Parse a tier hint that may carry a target level (§14.3).

    On an N-level :class:`~repro_torch.core.store.TierChain`, HOT and PIN_FAST
    generalize to *target-level* hints: ``"pin_fast:1"`` pins a range at
    cache level 1 or faster, ``"hot:2"`` asks the engine to place it at
    level 2 or faster.  The bare strings (and :class:`TierHint` members)
    keep their depth-2 meaning — target level 0, the fastest tier.

    Returns ``(hint, level)`` where ``level`` is ``None`` when the hint
    named no level (the engine then targets level 0).  COLD takes no
    level — a demotion drains toward the base tier regardless.
    """
    if isinstance(value, TierHint):
        return value, None
    text = str(value)
    level = None
    if ":" in text:
        name, _, lvl_s = text.partition(":")
        try:
            level = int(lvl_s)
        except ValueError:
            raise ValueError(f"bad tier hint level in {value!r}") from None
        if level < 0:
            raise ValueError(f"tier hint level must be >= 0, got {value!r}")
        text = name
    hint = TierHint(text)   # raises ValueError on unknown hint strings
    if hint is TierHint.COLD and level is not None:
        raise ValueError("tier_hint='cold' takes no target level")
    return hint, level


def apply_advice(config: UMapConfig, advice: AccessAdvice) -> UMapConfig:
    """Bake an advice's settings into a config (the paper's static path)."""
    return config.replace(**ADVICE_SETTINGS[advice])


# ------------------------------------------------- classifier <-> advice bridge

#: Online phase -> nearest static advice.  SCAN_REUSE maps to STREAMING:
#: both want deep readahead plus evict-lowest (for a cyclic scan larger than
#: the buffer, evicting the lowest page approximates Belady — the page just
#: read is the one whose reuse is furthest away).
_PHASE_TO_ADVICE = {
    Phase.WARMUP: AccessAdvice.NORMAL,
    Phase.SEQUENTIAL: AccessAdvice.SEQUENTIAL,
    Phase.STRIDED: AccessAdvice.STRIDED,
    Phase.RANDOM: AccessAdvice.RANDOM,
    Phase.SCAN_REUSE: AccessAdvice.STREAMING,
}

_ADVICE_TO_PHASE = {
    AccessAdvice.NORMAL: Phase.WARMUP,
    AccessAdvice.SEQUENTIAL: Phase.SEQUENTIAL,
    AccessAdvice.RANDOM: Phase.RANDOM,
    AccessAdvice.WILLNEED: Phase.RANDOM,
    AccessAdvice.STREAMING: Phase.SCAN_REUSE,
    AccessAdvice.STRIDED: Phase.STRIDED,
}


def advice_for_phase(phase: Phase) -> AccessAdvice:
    """Translate a detected :class:`~repro_torch.core.pattern.Phase` into the
    static advice vocabulary — what the classifier *would have advised* had
    the application known its pattern up front.  Used for telemetry and for
    feeding classifier output back through advice-driven code paths."""
    return _PHASE_TO_ADVICE[phase]


def phase_for_advice(advice: AccessAdvice) -> Phase:
    """Inverse bridge: the phase a static advice asserts the region is in.

    WILLNEED maps to RANDOM (the caller prefetches explicitly, so the pager
    should neither read ahead nor infer); NORMAL maps to WARMUP (no claim)."""
    return _ADVICE_TO_PHASE[advice]


# ----------------------------------------------- serving-tenant hints (§16)

def fair_shares(weights: "dict[str, float]", total_pages: int
                ) -> "dict[str, int]":
    """Apportion a page budget across tenants by weight (DESIGN.md §16.2).

    The serving engine's per-tenant watermark gate compares each tenant's
    page consumption against its fair share of the pool — the paper's §3.5
    occupancy watermark made tenant-relative.  Largest-remainder
    apportionment: shares sum exactly to ``total_pages``, every tenant with
    positive weight gets its floor, and leftover pages go to the largest
    fractional remainders (ties broken by tenant name for determinism).
    """
    if total_pages < 0:
        raise ValueError("total_pages must be >= 0")
    if not weights:
        return {}
    wsum = float(sum(weights.values()))
    if wsum <= 0 or any(w < 0 for w in weights.values()):
        raise ValueError("tenant weights must be non-negative, sum > 0")
    exact = {name: total_pages * w / wsum for name, w in weights.items()}
    shares = {name: int(exact[name]) for name in weights}
    leftover = total_pages - sum(shares.values())
    by_remainder = sorted(weights, key=lambda n: (shares[n] - exact[n], n))
    for name in by_remainder[:leftover]:
        shares[name] += 1
    return shares


def deadline_headroom_s(deadline_s: "float | None", submitted_at: float,
                        now: float) -> float:
    """Remaining SLO budget of a request in seconds (DESIGN.md §16.3).

    ``inf`` when the request carries no deadline — such requests always
    pass the SLO admission check and sort after any deadlined request.
    A negative value means the deadline has already been missed; admission
    does not defer those (deferring a lost cause frees nothing) but the
    engine marks them ``slo_miss`` on completion.
    """
    if deadline_s is None:
        return math.inf
    return deadline_s - (now - submitted_at)


def plan_prefetch(
    offsets: Iterable[int], page_size: int, max_pages: int = 256
) -> List[int]:
    """Future byte offsets -> deduplicated, bounded page list (in first-need order)."""
    seen, plan = set(), []
    for off in offsets:
        pno = off // page_size
        if pno not in seen:
            seen.add(pno)
            plan.append(pno)
            if len(plan) >= max_pages:
                break
    return plan


# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StoreProfile:
    """Per-operation latency + streaming bandwidth of a backing store."""

    latency_s: float
    bandwidth_Bps: float

    # Representative tiers (paper §3.2 quotes PM 100–500ns, NVMe ~20µs,
    # HDD ~ms; bandwidths are realistic per-device figures).
    @classmethod
    def nvme(cls):
        return cls(20e-6, 3e9)

    @classmethod
    def ssd_sata(cls):
        return cls(80e-6, 500e6)

    @classmethod
    def lustre_hdd(cls):
        return cls(5e-3, 200e6)

    @classmethod
    def pmem(cls):
        return cls(300e-9, 10e9)


@dataclasses.dataclass
class WorkloadProfile:
    """What the app knows: how much of each fetched page it will touch."""

    useful_bytes_per_access: int      # bytes the app actually consumes per touch
    locality_bytes: int               # span within which accesses cluster
    #  sort: locality ~ page (partition passes) -> big pages amortize faults
    #  nstore/YCSB: random keys, locality ~ record -> small pages win


class PageSizeAdvisor:
    """Cost model: t(page) = fault_overhead + latency + page/bandwidth, amortized
    over expected useful bytes min(page, locality).  Recommends the page size
    minimizing time per useful byte."""

    #: software fault-resolution overhead per fault (queue + wake + metadata);
    #: measured on this container by benchmarks/bench_fault_overhead.
    FAULT_OVERHEAD_S = 30e-6

    def __init__(self, store: StoreProfile, workload: WorkloadProfile):
        self.store = store
        self.workload = workload

    def time_per_useful_byte(self, page_size: int) -> float:
        useful = min(page_size, max(self.workload.locality_bytes,
                                    self.workload.useful_bytes_per_access))
        t = self.FAULT_OVERHEAD_S + self.store.latency_s + page_size / self.store.bandwidth_Bps
        return t / useful

    def recommend(self, candidates: Sequence[int] = tuple(4096 * 2**i for i in range(12))) -> int:
        return min(candidates, key=self.time_per_useful_byte)

    def sweep(self, candidates: Sequence[int]) -> dict:
        return {p: self.time_per_useful_byte(p) for p in candidates}


def bandwidth_delay_pages(store: StoreProfile, page_size: int) -> int:
    """Filler concurrency needed to saturate the store (sizing §3.2 pools).

    Little's law: in-flight ops = bandwidth × latency / page_size, i.e. the
    bandwidth-delay product in pages (+1 so the pipe never drains).  With
    20 µs NVMe latency and 4 KiB pages that is ~16 fillers; at 1 MiB pages a
    single filler saturates — why the paper's best filler counts shrink as
    page size grows (§6.1).
    """
    transfer_s = page_size / store.bandwidth_Bps
    return max(1, math.ceil(store.latency_s / transfer_s) + 1)
