"""UMap configuration — API + environment-variable controls (paper §4.1–4.2).

Every knob from the paper's §4.2 environment-variable list is represented with
the same name and the same default:

  UMAP_PAGESIZE                       internal page size (bytes)
  UMAP_PAGE_FILLERS                   # of read workers       (default: hw threads)
  UMAP_PAGE_EVICTORS                  # of eviction workers   (default: hw threads)
  UMAP_EVICT_HIGH_WATER_THRESHOLD     start evicting at this dirty ratio (default 90%)
  UMAP_EVICT_LOW_WATER_THRESHOLD     suspend evicting below this ratio  (default 70%)
  UMAP_BUFSIZE                        page-buffer bytes (default: 80% of available)
  UMAP_READ_AHEAD                     pages to read ahead on a demand fill (default 0)
  UMAP_MAX_FAULT_EVENTS               max fault events drained per poll (default: hw threads)

Extensions beyond the paper's list (this repo's adaptive engine, DESIGN.md §8–9):

  UMAP_ADAPTIVE                       enable the online access-pattern classifier (default off)
  UMAP_MAX_BATCH_PAGES                max adjacent pages per coalesced fill (default 16; 1 disables)
  UMAP_SHARDS                         page-metadata shard count (default 0 = min(16, 2*fillers))
  UMAP_MAX_WRITEBACK_BATCH            max adjacent dirty pages per coalesced write-back (default 16; 1 disables)
  UMAP_ZERO_COPY_LEASES               zero-copy lease views into the page buffer (default on)
  UMAP_MAX_LEASE_RUN                  max pages a single lease_run may pin (default 64)
  UMAP_WRITEBACK_RETRIES              write-back attempts before a page is quarantined (default 3)
  UMAP_TIER_CHAIN                     cache-level spec for TierChain.from_config, fastest first,
                                      e.g. "host:64M,file:/mnt/nvme/c.bin:1G" (default "" = off;
                                      no latency figures — tier speed is sampled online)
  UMAP_TIER_FAST_BYTES                DEPRECATED: legacy spelling of a depth-2 chain —
                                      "UMAP_TIER_FAST_BYTES=64M" maps to "UMAP_TIER_CHAIN=host:64M"
  UMAP_TIER_EXTENT                    tier migration extent size in bytes (default 1M)
  UMAP_TIER_INTERVAL_MS               migration-engine cycle interval (default 50 ms)
  UMAP_TIER_DECAY                     per-cycle heat/write-intensity decay factor (default 0.8)
  UMAP_TIER_PROMOTE_HEAT              heat threshold for promotion (default 2.0)
  UMAP_TIER_MAX_MIGRATIONS            max promote/demote pairs per cycle (default 8)
  UMAP_TIER_POLICY                    migration policy: "utility" (sampled-latency utility model)
                                      or "heat" (legacy threshold loop) (default utility)
  UMAP_TIER_EWMA_ALPHA                smoothing factor for the online latency samplers (default 0.2)
  UMAP_TIER_HYSTERESIS                victim-vs-candidate utility ratio below which an eviction
                                      swap proceeds (default 0.5)
  UMAP_RESILIENT_IO                   wrap region stores in ResilientStore + pager-level
                                      fill/write-back retries (default off; DESIGN.md §17)
  UMAP_RETRY_LIMIT                    retry attempts per store op after the first try (default 3)
  UMAP_RETRY_BACKOFF_MS               initial retry backoff (default 2 ms; doubles per retry)
  UMAP_RETRY_MAX_BACKOFF_MS           exponential backoff cap (default 100 ms)
  UMAP_RETRY_DEADLINE_MS              whole-op wall-clock budget incl. retries (default 2000 ms)
  UMAP_VERIFY_READS                   per-page CRC32 verified on store reads (default off)
  UMAP_HEDGE_DELAY_MS                 hedged-read trigger delay; 0 disables hedging (default 0)
  UMAP_BREAKER_THRESHOLD              consecutive failures that trip a store breaker (default 5)
  UMAP_BREAKER_RESET_MS               open -> half-open probe delay (default 500 ms)
  UMAP_BREAKER_PROBES                 half-open probe successes required to close (default 2)

Process-level controls read outside UMapConfig (not config fields):

  UMAP_TELEMETRY_PORT                 start the process-wide Prometheus exporter on
                                      this port; every PagingService self-registers
                                      its collectors (default unset = telemetry off;
                                      read by repro_torch.telemetry, DESIGN.md §15)
  UMAP_TELEMETRY_HOST                 exporter bind address (default 127.0.0.1)
  UMAP_BENCH_RESULTS_DIR              where benchmark runs write result JSON
                                      (default experiments/bench/; read by
                                      benchmarks.common)

Programmatic control mirrors the paper's ``umapcfg_set_xx`` interfaces:
construct :class:`UMapConfig` directly or call :func:`from_env`.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Callable, Optional

# ---------------------------------------------------------------------------

_SIZE_SUFFIXES = {
    "k": 1024,
    "kb": 1024,
    "kib": 1024,
    "m": 1024**2,
    "mb": 1024**2,
    "mib": 1024**2,
    "g": 1024**3,
    "gb": 1024**3,
    "gib": 1024**3,
}


def parse_size(text: str | int) -> int:
    """Parse ``"64K"``/``"8M"``/``"1GiB"``/plain-int size strings to bytes."""
    if isinstance(text, int):
        return text
    s = str(text).strip().lower()
    for suffix in sorted(_SIZE_SUFFIXES, key=len, reverse=True):
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * _SIZE_SUFFIXES[suffix])
    return int(s)


def _hw_threads() -> int:
    return os.cpu_count() or 1


def _available_memory_bytes() -> int:
    """Best-effort available physical memory (for the UMAP_BUFSIZE default)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 8 * 1024**3


# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UMapConfig:
    """Per-region page-management configuration (paper §3.6, §4).

    ``page_size`` is the *internal UMap page* — the finest granularity of data
    movement between the backing store and the page buffer.  It is the
    paper's central performance knob (§6: optimal values ranged from 32 KiB
    for N-Store to 8 MiB for umapsort).
    """

    # --- geometry -----------------------------------------------------------
    page_size: int = 4096                    # UMAP_PAGESIZE (bytes)
    buffer_size: int = 64 * 1024**2          # UMAP_BUFSIZE (bytes of page buffer)

    # --- worker pools (I/O decoupling, §3.2) --------------------------------
    num_fillers: int = dataclasses.field(default_factory=_hw_threads)
    num_evictors: int = dataclasses.field(default_factory=_hw_threads)
    max_fault_events: int = dataclasses.field(default_factory=_hw_threads)

    # --- dirty-page watermarks (§3.5) ---------------------------------------
    evict_high_water: float = 0.90           # start background flush
    evict_low_water: float = 0.70            # suspend background flush

    # --- policies (§3.6) ----------------------------------------------------
    read_ahead: int = 0                      # pages prefetched past a demand fill
    eviction_policy: str = "lru"             # "fifo" | "lru" | "clock" | "swa"
    # Optional app-supplied fault resolver (paper §4: plugin/callback arch —
    # the asteroid FITS handler uses this).  Signature: (page_no, buf) -> None
    fill_callback: Optional[Callable] = None

    # --- adaptive engine (DESIGN.md §8) -------------------------------------
    # When True, each non-hint-pinned region gets an online access-pattern
    # classifier (core/pattern.py) that retunes read_ahead / eviction policy
    # from the demand-fault stream.  Static hints always take precedence.
    adaptive: bool = False                   # UMAP_ADAPTIVE
    pattern_window: int = 64                 # fault page-numbers per window
    pattern_min_samples: int = 16            # faults before first classification
    pattern_interval: int = 8                # faults between classifications
    pattern_hysteresis: int = 2              # rounds to confirm a transition

    # --- fault coalescing (DESIGN.md §9) ------------------------------------
    # Fillers drain runs of adjacent pending pages and issue one batched
    # store read (BackingStore.read_into_batch).  1 disables coalescing; the
    # effective batch is min(max_batch_pages, store.batch_read_hint).
    max_batch_pages: int = 16                # UMAP_MAX_BATCH_PAGES

    # --- write-back coalescing + zero-copy leases (DESIGN.md §13) -----------
    # Evictors opportunistically drain the cleaner queue and group adjacent
    # dirty pages of one region into a single BackingStore.write_from_batch
    # call.  1 restores one-write-per-page; the effective batch is
    # min(max_writeback_batch, store.batch_write_hint).
    max_writeback_batch: int = 16            # UMAP_MAX_WRITEBACK_BATCH
    # When True, region.lease()/lease_run() return pinned views directly
    # into the page buffer (no memcpy).  When False, leases are copy-backed
    # (private snapshot, write-leases write back through region.write on
    # release) — a debugging mode that keeps the lease API while removing
    # all aliasing between application views and the buffer.
    zero_copy_leases: bool = True            # UMAP_ZERO_COPY_LEASES
    # Ceiling on pages one lease_run may pin at once.  Runs hold multiple
    # pins per thread, trading away the pager's one-pin-per-thread
    # deadlock-freedom argument; the cap (further clamped to half the
    # buffer by the service) bounds how much of the buffer one run can
    # hold, and lease_run's abort-and-retry protocol releases an
    # incomplete run's pins rather than deadlocking when several runs
    # contend for the same slots.
    max_lease_run: int = 64                  # UMAP_MAX_LEASE_RUN

    # --- I/O error propagation (DESIGN.md §14.4) ----------------------------
    # A failed write-back is retried this many times (the page stays
    # CLEANING, re-posted to the cleaner queue); past the bound the page is
    # quarantined: resident + dirty, excluded from cleaning and eviction,
    # and flush_region raises.  Fill (read) failures are never retried by
    # the pager — the error propagates as IOError to every fault waiter
    # and the *application's* retry is a fresh fault.
    writeback_retries: int = 3               # UMAP_WRITEBACK_RETRIES

    # --- tiered store + heat-driven migration (DESIGN.md §14) ---------------
    # Regions whose store is a TieredStore feed per-shard access-heat
    # counters (bumped on demand faults, keyed by store extent); a
    # dedicated migration thread decays them every `tier_interval_s` and
    # transactionally promotes hot extents / demotes cold ones.
    # Steady-state heat of an extent faulting at rate r is
    # r * tier_interval_s / (1 - tier_decay); the defaults promote extents
    # sustaining >= ~8 demand faults/s (heat 2.0 at 50 ms cycles, 0.8
    # decay — half-life ~0.16 s) while extents faulting 10x slower stay an
    # order of magnitude below the threshold.
    tier_fast_bytes: int = 0                 # UMAP_TIER_FAST_BYTES (deprecated depth-2 budget)
    tier_extent_size: int = 1 << 20          # UMAP_TIER_EXTENT
    tier_interval_s: float = 0.05            # UMAP_TIER_INTERVAL_MS / 1000
    tier_decay: float = 0.8                  # UMAP_TIER_DECAY (heat *= decay per cycle)
    tier_promote_heat: float = 2.0           # UMAP_TIER_PROMOTE_HEAT
    tier_max_migrations: int = 8             # UMAP_TIER_MAX_MIGRATIONS per cycle
    # N-tier chain spec (UMAP_TIER_CHAIN): comma-separated cache levels,
    # fastest first ("host:64M,file:/mnt/nvme/c.bin:1G"); the base tier is
    # the store the chain is built over.  Deliberately latency-free: tier
    # speed is sampled online (EWMA over observed I/O), never configured.
    tier_chain: str = ""                     # UMAP_TIER_CHAIN
    # Migration policy: "utility" ranks extents by
    #   utility = expected_accesses x sampled_latency_delta
    #             - write_intensity x demote_cost
    # and packs each level's byte budget by descending utility; "heat" is
    # the legacy level-0 threshold loop (kept as the A/B baseline).
    tier_policy: str = "utility"             # UMAP_TIER_POLICY
    tier_ewma_alpha: float = 0.2             # UMAP_TIER_EWMA_ALPHA (sampler smoothing)
    tier_hysteresis: float = 0.5             # UMAP_TIER_HYSTERESIS (swap ratio)

    # --- resilient I/O (DESIGN.md §17) --------------------------------------
    # When True, umap() wraps the region's store in a ResilientStore
    # (per-tier for TieredStore: each tier gets its own circuit breaker) and
    # the pager's fill/write-back paths retry transient store errors with
    # exponential backoff instead of raising on first failure.  A retry at
    # the pager level re-plans tiered routing, which is the transparent
    # fast-tier failover path while a breaker is open.  Default off: the
    # PR 5 fail-fast contract (one injected fault == one surfaced IOError)
    # is the debugging mode and what FaultyStore regression tests pin.
    resilient_io: bool = False               # UMAP_RESILIENT_IO
    io_retries: int = 3                      # UMAP_RETRY_LIMIT
    retry_backoff_s: float = 0.002           # UMAP_RETRY_BACKOFF_MS / 1000
    retry_max_backoff_s: float = 0.1         # UMAP_RETRY_MAX_BACKOFF_MS / 1000
    retry_deadline_s: float = 2.0            # UMAP_RETRY_DEADLINE_MS / 1000
    # CRC32 per page recorded at write-back/fill-install and verified on
    # store reads; a mismatch surfaces as retriable CorruptPageError.
    verify_reads: bool = False               # UMAP_VERIFY_READS
    # Hedged reads: if a read has not completed within hedge_delay_s, issue
    # a duplicate and take the first success (0 disables — hedging only
    # pays on high-latency remote tiers).
    hedge_delay_s: float = 0.0               # UMAP_HEDGE_DELAY_MS / 1000
    breaker_threshold: int = 5               # UMAP_BREAKER_THRESHOLD
    breaker_reset_s: float = 0.5             # UMAP_BREAKER_RESET_MS / 1000
    breaker_probes: int = 2                  # UMAP_BREAKER_PROBES

    # --- sharded concurrency (DESIGN.md §12) --------------------------------
    # Page metadata (table + slot free lists + eviction state) is striped
    # into `shards` independent lock domains keyed by hash(PageKey), so
    # concurrent faults on different pages never contend.  0 = auto
    # (min(16, 2 * num_fillers)); the service additionally clamps to the
    # slot count so every shard owns at least one buffer slot.  mmap_compat
    # forces a single shard (the kernel's mmap_sem serialization).
    shards: int = 0                          # UMAP_SHARDS

    # --- mmap-baseline emulation --------------------------------------------
    # When True, the pager is frozen to kernel-mmap semantics: 4 KiB pages,
    # synchronous fault resolution, heuristic seq/random readahead, and an
    # aggressive 10%-dirty flush threshold (RHEL default per paper §3.5).
    mmap_compat: bool = False

    def __post_init__(self):
        if self.page_size <= 0:
            raise ValueError(f"page_size must be positive, got {self.page_size}")
        if self.buffer_size < self.page_size:
            raise ValueError(
                f"buffer_size ({self.buffer_size}) < page_size ({self.page_size})"
            )
        if not (0.0 < self.evict_low_water <= self.evict_high_water <= 1.0):
            raise ValueError(
                "watermarks must satisfy 0 < low <= high <= 1, got "
                f"low={self.evict_low_water} high={self.evict_high_water}"
            )
        if self.num_fillers < 1 or self.num_evictors < 1:
            raise ValueError("need at least one filler and one evictor")
        if self.max_batch_pages < 1:
            raise ValueError(f"max_batch_pages must be >= 1, got {self.max_batch_pages}")
        if self.max_writeback_batch < 1:
            raise ValueError(
                f"max_writeback_batch must be >= 1, got {self.max_writeback_batch}")
        if self.max_lease_run < 1:
            raise ValueError(f"max_lease_run must be >= 1, got {self.max_lease_run}")
        if self.pattern_window < 4:
            raise ValueError(f"pattern_window must be >= 4, got {self.pattern_window}")
        if self.shards < 0:
            raise ValueError(f"shards must be >= 0 (0 = auto), got {self.shards}")
        if self.writeback_retries < 1:
            raise ValueError(
                f"writeback_retries must be >= 1, got {self.writeback_retries}")
        if self.tier_extent_size < 1:
            raise ValueError(
                f"tier_extent_size must be >= 1, got {self.tier_extent_size}")
        if self.tier_interval_s <= 0:
            raise ValueError(
                f"tier_interval_s must be positive, got {self.tier_interval_s}")
        if not (0.0 < self.tier_decay < 1.0):
            raise ValueError(
                f"tier_decay must be in (0, 1), got {self.tier_decay}")
        if self.tier_promote_heat <= 0:
            raise ValueError(
                f"tier_promote_heat must be positive, "
                f"got {self.tier_promote_heat}")
        if self.tier_max_migrations < 1:
            raise ValueError(
                f"tier_max_migrations must be >= 1, got {self.tier_max_migrations}")
        if self.tier_policy not in ("utility", "heat"):
            raise ValueError(
                f"tier_policy must be 'utility' or 'heat', got {self.tier_policy!r}")
        if not (0.0 < self.tier_ewma_alpha <= 1.0):
            raise ValueError(
                f"tier_ewma_alpha must be in (0, 1], got {self.tier_ewma_alpha}")
        if self.tier_hysteresis < 0:
            raise ValueError(
                f"tier_hysteresis must be >= 0, got {self.tier_hysteresis}")
        if self.io_retries < 0:
            raise ValueError(f"io_retries must be >= 0, got {self.io_retries}")
        if self.retry_backoff_s < 0 or self.retry_max_backoff_s < 0:
            raise ValueError("retry backoffs must be >= 0")
        if self.retry_deadline_s <= 0:
            raise ValueError(
                f"retry_deadline_s must be positive, got {self.retry_deadline_s}")
        if self.hedge_delay_s < 0:
            raise ValueError(
                f"hedge_delay_s must be >= 0 (0 = off), got {self.hedge_delay_s}")
        if self.breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {self.breaker_threshold}")
        if self.breaker_reset_s <= 0:
            raise ValueError(
                f"breaker_reset_s must be positive, got {self.breaker_reset_s}")
        if self.breaker_probes < 1:
            raise ValueError(
                f"breaker_probes must be >= 1, got {self.breaker_probes}")

    @property
    def num_slots(self) -> int:
        """Number of page slots in the buffer."""
        return max(1, self.buffer_size // self.page_size)

    @property
    def effective_shards(self) -> int:
        """Shard count a service built from this config instantiates.

        ``shards == 0`` selects the auto heuristic ``min(16, 2 * fillers)``
        (enough stripes that fillers plus app threads rarely collide, without
        fragmenting tiny buffers); the result is clamped so every stripe
        owns at least ``MIN_SLOTS_PER_SHARD`` buffer slots — slot free lists
        are stripe-private, and 1–2-slot stripes thrash (two hot pages on
        one stripe evict each other on every touch even while other stripes
        sit on free slots).  ``mmap_compat`` pins the count to 1 — the
        kernel's single ``mmap_sem`` domain is exactly the bottleneck the
        sharded pager removes (DESIGN.md §12).
        """
        if self.mmap_compat:
            return 1
        n = self.shards if self.shards > 0 else min(16, 2 * self.num_fillers)
        return max(1, min(n, self.num_slots // self.MIN_SLOTS_PER_SHARD))

    #: Floor on buffer slots per metadata stripe (see ``effective_shards``).
    MIN_SLOTS_PER_SHARD = 4

    def replace(self, **kw) -> "UMapConfig":
        return dataclasses.replace(self, **kw)

    # --- constructors --------------------------------------------------------

    @classmethod
    def from_env(cls, env: Optional[dict] = None, **overrides) -> "UMapConfig":
        """Build a config from ``UMAP_*`` environment variables (paper §4.2)."""
        env = dict(os.environ if env is None else env)
        kw = {}
        if "UMAP_PAGESIZE" in env:
            kw["page_size"] = parse_size(env["UMAP_PAGESIZE"])
        if "UMAP_BUFSIZE" in env:
            kw["buffer_size"] = parse_size(env["UMAP_BUFSIZE"])
        else:
            kw["buffer_size"] = int(0.8 * _available_memory_bytes())
        if "UMAP_PAGE_FILLERS" in env:
            kw["num_fillers"] = int(env["UMAP_PAGE_FILLERS"])
        if "UMAP_PAGE_EVICTORS" in env:
            kw["num_evictors"] = int(env["UMAP_PAGE_EVICTORS"])
        if "UMAP_EVICT_HIGH_WATER_THRESHOLD" in env:
            kw["evict_high_water"] = float(env["UMAP_EVICT_HIGH_WATER_THRESHOLD"]) / 100.0
        if "UMAP_EVICT_LOW_WATER_THRESHOLD" in env:
            kw["evict_low_water"] = float(env["UMAP_EVICT_LOW_WATER_THRESHOLD"]) / 100.0
        if "UMAP_READ_AHEAD" in env:
            kw["read_ahead"] = int(env["UMAP_READ_AHEAD"])
        if "UMAP_MAX_FAULT_EVENTS" in env:
            kw["max_fault_events"] = int(env["UMAP_MAX_FAULT_EVENTS"])
        if "UMAP_ADAPTIVE" in env:
            kw["adaptive"] = env["UMAP_ADAPTIVE"].strip().lower() in ("1", "true", "yes", "on")
        if "UMAP_MAX_BATCH_PAGES" in env:
            kw["max_batch_pages"] = int(env["UMAP_MAX_BATCH_PAGES"])
        if "UMAP_SHARDS" in env:
            kw["shards"] = int(env["UMAP_SHARDS"])
        if "UMAP_MAX_WRITEBACK_BATCH" in env:
            kw["max_writeback_batch"] = int(env["UMAP_MAX_WRITEBACK_BATCH"])
        if "UMAP_ZERO_COPY_LEASES" in env:
            kw["zero_copy_leases"] = (env["UMAP_ZERO_COPY_LEASES"].strip().lower()
                                      in ("1", "true", "yes", "on"))
        if "UMAP_MAX_LEASE_RUN" in env:
            kw["max_lease_run"] = int(env["UMAP_MAX_LEASE_RUN"])
        if "UMAP_WRITEBACK_RETRIES" in env:
            kw["writeback_retries"] = int(env["UMAP_WRITEBACK_RETRIES"])
        if "UMAP_TIER_CHAIN" in env:
            kw["tier_chain"] = env["UMAP_TIER_CHAIN"].strip()
        if "UMAP_TIER_FAST_BYTES" in env:
            kw["tier_fast_bytes"] = parse_size(env["UMAP_TIER_FAST_BYTES"])
            if "UMAP_TIER_CHAIN" not in env and kw["tier_fast_bytes"] >= 1:
                # Deprecated shim: the byte budget is exactly a depth-2
                # chain with one host-memory cache level.
                warnings.warn(
                    "UMAP_TIER_FAST_BYTES is deprecated; set "
                    f"UMAP_TIER_CHAIN=host:{kw['tier_fast_bytes']} instead",
                    DeprecationWarning, stacklevel=2)
                kw["tier_chain"] = f"host:{kw['tier_fast_bytes']}"
        if "UMAP_TIER_EXTENT" in env:
            kw["tier_extent_size"] = parse_size(env["UMAP_TIER_EXTENT"])
        if "UMAP_TIER_INTERVAL_MS" in env:
            kw["tier_interval_s"] = float(env["UMAP_TIER_INTERVAL_MS"]) / 1000.0
        if "UMAP_TIER_DECAY" in env:
            kw["tier_decay"] = float(env["UMAP_TIER_DECAY"])
        if "UMAP_TIER_PROMOTE_HEAT" in env:
            kw["tier_promote_heat"] = float(env["UMAP_TIER_PROMOTE_HEAT"])
        if "UMAP_TIER_MAX_MIGRATIONS" in env:
            kw["tier_max_migrations"] = int(env["UMAP_TIER_MAX_MIGRATIONS"])
        if "UMAP_TIER_POLICY" in env:
            kw["tier_policy"] = env["UMAP_TIER_POLICY"].strip().lower()
        if "UMAP_TIER_EWMA_ALPHA" in env:
            kw["tier_ewma_alpha"] = float(env["UMAP_TIER_EWMA_ALPHA"])
        if "UMAP_TIER_HYSTERESIS" in env:
            kw["tier_hysteresis"] = float(env["UMAP_TIER_HYSTERESIS"])
        _truthy = ("1", "true", "yes", "on")
        if "UMAP_RESILIENT_IO" in env:
            kw["resilient_io"] = env["UMAP_RESILIENT_IO"].strip().lower() in _truthy
        if "UMAP_RETRY_LIMIT" in env:
            kw["io_retries"] = int(env["UMAP_RETRY_LIMIT"])
        if "UMAP_RETRY_BACKOFF_MS" in env:
            kw["retry_backoff_s"] = float(env["UMAP_RETRY_BACKOFF_MS"]) / 1000.0
        if "UMAP_RETRY_MAX_BACKOFF_MS" in env:
            kw["retry_max_backoff_s"] = float(env["UMAP_RETRY_MAX_BACKOFF_MS"]) / 1000.0
        if "UMAP_RETRY_DEADLINE_MS" in env:
            kw["retry_deadline_s"] = float(env["UMAP_RETRY_DEADLINE_MS"]) / 1000.0
        if "UMAP_VERIFY_READS" in env:
            kw["verify_reads"] = env["UMAP_VERIFY_READS"].strip().lower() in _truthy
        if "UMAP_HEDGE_DELAY_MS" in env:
            kw["hedge_delay_s"] = float(env["UMAP_HEDGE_DELAY_MS"]) / 1000.0
        if "UMAP_BREAKER_THRESHOLD" in env:
            kw["breaker_threshold"] = int(env["UMAP_BREAKER_THRESHOLD"])
        if "UMAP_BREAKER_RESET_MS" in env:
            kw["breaker_reset_s"] = float(env["UMAP_BREAKER_RESET_MS"]) / 1000.0
        if "UMAP_BREAKER_PROBES" in env:
            kw["breaker_probes"] = int(env["UMAP_BREAKER_PROBES"])
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def mmap_baseline(cls, buffer_size: int, **overrides) -> "UMapConfig":
        """The 'system service' baseline the paper compares against (§6).

        Kernel-mmap semantics: fixed 4 KiB pages, fault resolved synchronously
        on the faulting thread (one implicit filler), heuristic readahead, and
        flush-at-10%-dirty.
        """
        kw = dict(
            page_size=4096,
            buffer_size=buffer_size,
            num_fillers=1,
            num_evictors=1,
            evict_high_water=0.10,
            evict_low_water=0.05,
            read_ahead=0,          # heuristic readahead handled by pager
            eviction_policy="lru",
            mmap_compat=True,
            adaptive=False,        # the kernel has no app-pattern engine
            max_batch_pages=1,     # kernel faults resolve one page at a time
            max_writeback_batch=1,  # and writes back one page at a time
            shards=1,              # one mmap_sem domain per address space
        )
        kw.update(overrides)
        return cls(**kw)
