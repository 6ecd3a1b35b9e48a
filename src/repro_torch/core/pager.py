"""Paging service: sharded metadata, work-stealing fillers, decoupled I/O.

Structure (paper §3.1–3.3, Figure 1, plus the sharded-concurrency redesign
documented in DESIGN.md §12):

  * Application threads touching a region post *fault events* and block on
    the page's event (the userfaultfd analogue: the faulting thread sleeps;
    it is woken only after the page is atomically installed — UFFDIO_COPY
    semantics).
  * Page metadata is striped into N **shards** (``config.shards`` /
    ``UMAP_SHARDS``, default ``min(16, 2*fillers)``), keyed by
    ``hash((region_id, page_no)) % N``.  Each shard owns its own lock +
    condition, page table, eviction-policy instance, buffer-slot free list,
    and stat counters — concurrent faults on *different* pages contend only
    when they hash to the same stripe.  The seed design's single global
    ``RLock`` is exactly the centralized page-metadata locking that eBPF-mm
    and the SVM studies (PAPERS.md) identify as the first scalability wall.
  * A pool of **fillers** serves fills from *per-filler deques*: fill work
    is routed by coalescing granule (adjacent pages land on one deque so
    they can resolve as one batched store read), and an idle filler
    **steals** a batch from the busiest peer — the paper's §3.3 dynamic
    load balancing as an explicit protocol rather than a shared queue.
  * The read path is **decoupled from the write path**: fillers only ever
    read.  A filler that needs a slot drops *clean* victims inline (no I/O)
    and, when none exist, posts dirty pages to the dedicated **cleaner
    queue** and waits — write-back is performed exclusively by the evictor
    pool, driven by watermark backpressure (watermark.py), so a write-back
    burst can no longer stall demand fills.
  * A low-concurrency **manager** (the watermark monitor thread) polls
    dirty state, mirroring the paper's manager threads.

I/O always happens *outside* shard locks, so fillers genuinely overlap on
stores whose reads release the GIL (file I/O, remote-latency sleeps).

Lock ordering (DESIGN.md §12 — violating this is a deadlock):

  1. ``service.lock`` (region registry, policy swaps, adaptive retunes)
  2. one shard lock at a time (never two shards simultaneously)
  3. one fill-deque condition at a time (never two nested)

Engine extensions beyond the paper's static design (DESIGN.md §8–9, §13):

  * **Adaptive retuning** — with ``config.adaptive``, every non-hint-pinned
    region gets an online access-pattern classifier (pattern.py) fed by the
    demand-fault stream; confirmed phase transitions retune the region's
    readahead (stride-aware) and the service's eviction policy mid-run.
    Static hints (explicit ``readahead_pages=`` or ``region.advise``) always
    take precedence — the classifier never touches pinned regions.
  * **Fault coalescing** — fillers drain runs of *adjacent* pending pages
    from their own deque and resolve them with one batched store read
    (``BackingStore.read_into_batch``): one latency charge / syscall per
    run, pages installed under per-shard lock acquisitions, every blocked
    faulting thread woken.  ``config.max_batch_pages=1`` disables it.
  * **Zero-copy leases** — ``lease_page``/``lease_run`` hand the
    application pinned views directly into the page buffer (no memcpy);
    the pin makes the page ineligible for eviction/write-back, and the
    cleaner re-checks pins at dequeue time (core/lease.py, DESIGN.md §13).
  * **Coalesced write-back** — evictors drain the cleaner queue in
    batches, regroup adjacent dirty pages per region, and write each run
    with ONE ``BackingStore.write_from_batch`` call; ``flush_region``
    shares the same pipeline.  ``config.max_writeback_batch=1`` restores
    one-write-per-page.
  * **Heat-driven tier migration** (DESIGN.md §14) — regions backed by a
    ``TieredStore`` feed per-shard access-heat counters from the demand-
    fault stream; a dedicated migration thread decays them each cycle and
    transactionally promotes hot extents into / demotes cold extents out
    of the fast tier.  ``region.advise(tier_hint=...)`` overrides heat.
  * **I/O error propagation** (DESIGN.md §14.4) — fill failures raise
    ``IOError`` at every blocked fault site (``entry.error``); write-back
    failures retry boundedly, then quarantine the page and make
    ``flush_region`` raise.  Failing stores can no longer cause silent
    infinite re-fault loops or stranded dirty pages.

The ``mmap_compat`` configuration freezes this machinery to kernel-mmap
semantics (synchronous resolution on the faulting thread serialized on an
``mmap_sem`` analogue, ONE metadata shard, heuristic readahead, 10%-dirty
flush, no coalescing, no adaptation) and is the paper's comparison baseline.
"""

from __future__ import annotations

import contextlib
import os
import queue
import random
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, TYPE_CHECKING

from .buffer import EvictionPolicy, PageBuffer, make_policy
from .config import UMapConfig
from .lease import LeaseRun, PageLease
from .pagetable import (
    PageEntry,
    PageKey,
    PageState,
    PageTable,
    ShardedPageTableView,
)
from .pattern import AccessPatternClassifier
from .watermark import WatermarkMonitor

if TYPE_CHECKING:  # pragma: no cover
    from .region import UMapRegion


# Counters that live in a shard and are mutated only under that shard's lock
# (the seed design incremented some of these outside its global lock — the
# per-shard discipline is the data-race fix, and snapshot() aggregates them
# lock-free: int reads are GIL-consistent).
_SHARD_COUNTERS = (
    "demand_faults", "page_hits", "wait_hits", "prefetch_fills",
    "prefetch_hits", "evictions", "writebacks", "coalesced_fills",
    "coalesced_pages", "lock_contended", "fill_stalls",
    "coalesced_writebacks", "writeback_pages", "leases",
    "lease_blocked_evictions", "lease_excl_waits", "io_errors",
    "writeback_errors", "quarantined_pages", "quarantine_retries",
)

# Service-level counters: each has a single writer thread (watermark
# monitor, classifier path under service.lock, the tier-migration thread
# for tier_*) — except fill_queue_peak, a telemetry-only racy max
# documented in _submit_fill_many.  Steal accounting lives in per-filler
# single-writer dicts instead.
_SERVICE_COUNTERS = (
    "watermark_flushes", "fill_queue_peak", "pattern_transitions",
    "tier_promotions", "tier_demotions", "tier_errors", "tier_cycles",
)


@dataclass
class ServiceStats:
    """Aggregated service statistics (see ``PagingService.stats``).

    Constructed on demand from per-shard counters; ``per_shard`` carries the
    un-aggregated stripe detail (contention, stalls, fills per shard).
    """

    demand_faults: int = 0
    prefetch_fills: int = 0
    prefetch_hits: int = 0          # prefetched pages later touched
    page_hits: int = 0              # touches that found the page present
    wait_hits: int = 0              # touches that waited on an in-flight fill
    evictions: int = 0
    writebacks: int = 0
    watermark_flushes: int = 0
    fill_queue_peak: int = 0
    coalesced_fills: int = 0        # batched fill operations (>= 2 pages each)
    coalesced_pages: int = 0        # pages installed via batched fills
    coalesced_writebacks: int = 0   # batched write-back ops (>= 2 pages each)
    writeback_pages: int = 0        # pages written via batched write-backs
    leases: int = 0                 # zero-copy leases granted (DESIGN.md §13)
    lease_blocked_evictions: int = 0  # victim/clean skips due to live leases
    lease_excl_waits: int = 0       # grant waits for writer/snapshot exclusion (§18.4)
    io_errors: int = 0              # fills that died on a store exception (§14.4)
    writeback_errors: int = 0       # failed write-back attempts (§14.4)
    quarantined_pages: int = 0      # currently quarantined (§17.4 re-post decrements)
    quarantine_retries: int = 0     # quarantined pages re-posted for cleaning (§17)
    pattern_transitions: int = 0    # classifier-driven retunes applied
    tier_promotions: int = 0        # extents migrated toward a faster tier (§14)
    tier_demotions: int = 0         # extent copies dropped from a cache tier
    tier_errors: int = 0            # migration cycles/ops that died on store I/O
    tier_cycles: int = 0            # migration-engine passes completed (§14.5)
    shards: int = 1                 # metadata stripe count
    steals: int = 0                 # work-stealing events (idle filler stole)
    stolen_work: int = 0            # fill work items moved by stealing
    lock_contended: int = 0         # shard-lock acquisitions that had to wait
    fill_stalls: int = 0            # fills that waited on cleaner backpressure
    per_filler_fills: Dict[int, int] = field(default_factory=dict)
    per_shard: List[dict] = field(default_factory=list)

    def snapshot(self) -> dict:
        """Plain-dict copy of the stats — the stable telemetry schema.

        **Consistency contract (by design):** the snapshot is NOT a
        consistent point-in-time cut across shards.  ``PagingService.stats``
        aggregates per-shard counters *lock-free* (individual int reads are
        GIL-consistent, but shard 3 may be read microseconds after shard 0,
        with fills landing in between), precisely so that reading stats —
        including a telemetry scrape — can never block a fill, an eviction,
        or a faulting application thread.  Consequences callers may rely on:

        * every individual counter value was true at some instant and is
          monotonically non-decreasing across snapshots (counter semantics);
        * cross-counter invariants (e.g. ``demand_faults`` vs. the sum of
          ``per_shard`` faults) hold exactly only once the service is
          quiescent — under load they can be transiently off by in-flight
          operations;
        * the key set IS stable: every ``_SHARD_COUNTERS`` key appears both
          at top level and in each ``per_shard`` dict, and every
          ``_SERVICE_COUNTERS`` key at top level (pinned by the
          stats-key-parity tests in tests/test_sharded_pager.py).
        """
        d = {k: v for k, v in self.__dict__.items()
             if k not in ("per_filler_fills", "per_shard")}
        d["per_filler_fills"] = dict(self.per_filler_fills)
        d["per_shard"] = [dict(s) for s in self.per_shard]
        return d


class _Shard:
    """One metadata stripe: lock, condition, table, policy, slots, counters."""

    __slots__ = ("index", "lock", "cond", "table", "policy", "free", "counters",
                 "heat", "wheat")

    def __init__(self, index: int, policy_name: str):
        self.index = index
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.table = PageTable()
        self.policy: EvictionPolicy = make_policy(policy_name)
        self.free: List[int] = []        # buffer slots owned by this shard
        self.counters: Dict[str, int] = {k: 0 for k in _SHARD_COUNTERS}
        # Access-heat accounting for tiered regions (DESIGN.md §14.1):
        # (region_id, extent_no) -> decayed demand-fault count, mutated
        # under this shard's lock, decayed + aggregated by the migration
        # thread.  Empty (zero overhead) unless a TierChain region is
        # registered.
        self.heat: Dict[tuple, float] = {}
        # Write-intensity twin (§14.5): decayed dirty-mark count per extent,
        # same keying and lifecycle.  The utility model charges write-heavy
        # extents their eventual demote write-back.
        self.wheat: Dict[tuple, float] = {}


class _FillWork:
    __slots__ = ("region", "entry")

    def __init__(self, region: "UMapRegion", entry: PageEntry):
        self.region = region
        self.entry = entry


_SHUTDOWN = object()


class PagingService:
    """Shared buffer + worker pools serving one or more UMap regions."""

    def __init__(self, config: UMapConfig):
        self.config = config
        # Service-level lock: region registry, runtime policy swaps, adaptive
        # retunes.  Ordering: may be held while taking ONE shard lock; shard
        # locks must never be held while taking this (DESIGN.md §12).
        self.lock = threading.RLock()
        self.buffer = PageBuffer(config.num_slots, config.page_size)

        nshards = config.effective_shards
        self.shards: List[_Shard] = [
            _Shard(i, config.eviction_policy) for i in range(nshards)
        ]
        for shard, slots in zip(self.shards, self.buffer.partition(nshards)):
            shard.free = slots
        self.table = ShardedPageTableView(
            [s.table for s in self.shards], self._shard_index)

        self._svc: Dict[str, int] = {k: 0 for k in _SERVICE_COUNTERS}
        self._per_filler_fills: Dict[int, int] = {}
        # Steal accounting is per-filler (single writer each), aggregated in
        # `stats` — no shared mutable counter, hence no data race.
        self._per_filler_steals: Dict[int, int] = {}
        self._per_filler_stolen: Dict[int, int] = {}
        self._regions: Dict[int, "UMapRegion"] = {}
        self._classifiers: Dict[int, AccessPatternClassifier] = {}
        self._next_region_id = 0
        self._closed = False
        # Worker threads close() could not join within its deadline (their
        # store call outlived the bounded join — DESIGN.md §17.7).  They are
        # daemons; the list makes the leak loud and testable.
        self.leaked_threads: List[str] = []
        # Breaker listeners installed per region (removed at unregister):
        # region_id -> [(breaker, fn), ...].
        self._breaker_hooks: Dict[int, List] = {}

        # Telemetry opt-in state (DESIGN.md §15): None until
        # register_telemetry() runs — zero overhead when unused.  Holds
        # (registry, label, registered-names, seen-tiered-store-ids).
        self._telemetry: Optional[tuple] = None

        # Read path: per-filler deques + work stealing, each deque guarded by
        # its OWN condition — there is no global queue lock (a shared one
        # re-centralizes contention as a steal ping-pong convoy the moment
        # fillers outpace posters).  Submission notifies the routed owner;
        # idle fillers rescan on a short timeout and steal from the busiest
        # peer.  Never hold two deque locks at once (steal moves work in two
        # independent critical sections).
        self._fill_qs: List[deque] = []
        self._fill_cvs: List[threading.Condition] = []
        self._fill_shutdown = False

        # Write path: the dedicated cleaner queue.  Fillers never write;
        # dirty pages drain through here (watermark backpressure or direct
        # filler pressure when a shard runs out of clean victims).
        self._clean_q: "queue.Queue" = queue.Queue()

        # Tier-migration engine (DESIGN.md §14): started lazily when the
        # first TieredStore-backed region registers.  Single thread — the
        # sole writer of the tier_* service counters and the only caller
        # of store.promote()/demote() besides inline read-through fills.
        self._tier_cv = threading.Condition()
        self._tier_thread: Optional[threading.Thread] = None
        self._tier_stop = False
        # "hot:<level>" hint targets: (region_id, extent) -> chain level the
        # app asked the extent to land at (§14.4).  Guarded by _tier_cv's
        # lock; pruned when the seeded heat decays away.
        self._hot_targets: Dict[tuple, int] = {}

        # Kernel-mmap fidelity: Linux serializes fault handling per address
        # space on mmap_sem — the scalability bottleneck the paper's related
        # work ([16], DI-MMAP) documents.  The mmap baseline reproduces it;
        # UMap's whole point is that its fill path does not take such a lock.
        self._mmap_sem = threading.Lock() if config.mmap_compat else None

        self._fillers: List[threading.Thread] = []
        self._evictors: List[threading.Thread] = []
        if not config.mmap_compat:
            self._fill_qs = [deque() for _ in range(config.num_fillers)]
            self._fill_cvs = [threading.Condition()
                              for _ in range(config.num_fillers)]
            for i in range(config.num_fillers):
                t = threading.Thread(target=self._filler_loop, args=(i,),
                                     name=f"umap-filler-{i}", daemon=True)
                t.start()
                self._fillers.append(t)
        for i in range(config.num_evictors):
            t = threading.Thread(target=self._evictor_loop, args=(i,),
                                 name=f"umap-evictor-{i}", daemon=True)
            t.start()
            self._evictors.append(t)

        # The "manager": monitors dirty ratio against the watermarks and
        # posts flush batches to the cleaner queue (paper §3.5).
        self.watermark = WatermarkMonitor(self)
        self.watermark.start()

        # Env-driven observability (DESIGN.md §15): with
        # UMAP_TELEMETRY_PORT set, every service self-registers with the
        # process-wide registry and the shared Prometheus exporter starts
        # on first use.  Unset (default): one dict lookup, nothing else —
        # telemetry failures must never take down the pager.
        if os.environ.get("UMAP_TELEMETRY_PORT", "").strip() not in ("", "0"):
            try:
                from .. import telemetry as _telemetry
                _telemetry.start_from_env()
                self.register_telemetry()
            except Exception:        # pragma: no cover - defensive only
                pass

    # ----------------------------------------------------------- sharding

    def _shard_index(self, key: PageKey) -> int:
        return hash(key) % len(self.shards)

    def _shard_of(self, key: PageKey) -> _Shard:
        return self.shards[hash(key) % len(self.shards)]

    @contextlib.contextmanager
    def _locked(self, shard: _Shard):
        """Acquire a shard lock adaptively, counting contended acquisitions.

        Adaptive-mutex discipline (glibc ``PTHREAD_MUTEX_ADAPTIVE_NP``):
        on a failed fast acquire, yield the scheduler once and retry before
        futex-parking.  Shard critical sections are microseconds, so a
        transient collision — the common case at healthy stripe counts —
        resolves on the yield and never parks; parking (and the lock-convoy
        regime it can enter, DESIGN.md §12.2) is reserved for sustained
        contention.
        """
        contended = not shard.lock.acquire(blocking=False)
        if contended:
            time.sleep(0)                    # one scheduler yield, then park
            if not shard.lock.acquire(blocking=False):
                shard.lock.acquire()
            shard.counters["lock_contended"] += 1
        try:
            yield
        finally:
            shard.lock.release()

    @property
    def policy(self) -> EvictionPolicy:
        """The current eviction policy (all shards run the same one)."""
        return self.shards[0].policy

    @property
    def stats(self) -> ServiceStats:
        """Lock-free aggregate of per-shard + service counters."""
        agg = ServiceStats(shards=len(self.shards))
        for shard in self.shards:
            c = shard.counters
            for k in _SHARD_COUNTERS:
                setattr(agg, k, getattr(agg, k) + c[k])
        for k in _SERVICE_COUNTERS:
            setattr(agg, k, self._svc[k])
        agg.steals = sum(self._per_filler_steals.values())
        agg.stolen_work = sum(self._per_filler_stolen.values())
        agg.per_filler_fills = dict(self._per_filler_fills)
        agg.per_shard = [dict(s.counters) for s in self.shards]
        return agg

    # ------------------------------------------------------- telemetry hook

    _svc_seq = 0          # class-level: default telemetry label uniquifier

    def register_telemetry(self, registry=None, label: Optional[str] = None
                           ) -> List[str]:
        """Opt this service into the telemetry registry (DESIGN.md §15).

        Registers a pager collector and a lease collector over this
        service's lock-free stats path; tiered regions registered now or
        later additionally get a tiering collector for their store.  The
        collectors are removed again in :meth:`close`.  Returns the
        registry names.  Idempotent; zero overhead when never called —
        collectors sample only when scraped.
        """
        from ..telemetry import default_registry
        from ..telemetry.collectors import LeaseCollector, PagerCollector
        with self.lock:
            if self._telemetry is not None:
                return list(self._telemetry[2])
            reg = registry if registry is not None else default_registry()
            if label is None:
                label = f"svc{PagingService._svc_seq}"
                PagingService._svc_seq += 1
            names = [
                reg.register(PagerCollector(self, label=label)),
                reg.register(LeaseCollector(service=self, label=label)),
            ]
            self._telemetry = (reg, label, names, set())
            regions = list(self._regions.items())
        for rid, region in regions:  # tiered regions registered before opt-in
            self._register_tier_collector(region, rid)
        return names

    def _register_tier_collector(self, region: "UMapRegion",
                                 rid: int) -> None:
        """Add per-store collectors for a region (once per distinct store
        object; no-op unless telemetry is enabled): a tiering collector for
        a TieredStore, plus one resilience collector per ResilientStore
        reachable from the region's store (the store itself, or each
        wrapped tier — DESIGN.md §17.8)."""
        if self._telemetry is None:
            return
        from ..telemetry.collectors import ResilienceCollector, TieringCollector
        store = region.store
        levels = getattr(store, "levels", None)
        if levels is not None:               # tier chain: tag every level
            last = len(levels) - 1
            tagged = [("", store)] + [
                ("/fast" if lvl == 0 else
                 "/slow" if lvl == last else f"/t{lvl}", s)
                for lvl, s in enumerate(levels)]
        else:
            tagged = [("", store), ("/fast", getattr(store, "fast", None)),
                      ("/slow", getattr(store, "slow", None))]
        resilient = [(tag, s) for tag, s in tagged
                     if hasattr(s, "resilience_stats")]
        if not getattr(region, "tiered", False) and not resilient:
            return
        with self.lock:
            if self._telemetry is None:
                return
            reg, label, names, seen_stores = self._telemetry
            if getattr(region, "tiered", False) and id(store) not in seen_stores:
                seen_stores.add(id(store))
                names.append(reg.register(TieringCollector(
                    store, label=f"{label}/r{rid}")))
            for tag, s in resilient:
                if id(s) in seen_stores:
                    continue
                seen_stores.add(id(s))
                names.append(reg.register(ResilienceCollector(
                    s, label=f"{label}/r{rid}{tag}")))

    def unregister_telemetry(self) -> None:
        with self.lock:
            tele, self._telemetry = self._telemetry, None
        if tele is not None:
            reg, _, names, _ = tele
            for name in names:
                reg.unregister(name)

    # ------------------------------------------------------------------ API

    def register(self, region: "UMapRegion") -> int:
        with self.lock:
            rid = self._next_region_id
            self._next_region_id += 1
            self._regions[rid] = region
            if (self.config.adaptive and not self.config.mmap_compat
                    and not getattr(region, "hint_pinned", False)):
                self._classifiers[rid] = AccessPatternClassifier(
                    window=self.config.pattern_window,
                    min_samples=self.config.pattern_min_samples,
                    interval=self.config.pattern_interval,
                    hysteresis=self.config.pattern_hysteresis,
                )
            if region.tiered and not self.config.mmap_compat \
                    and self._tier_thread is None:
                t = threading.Thread(target=self._tier_loop,
                                     name="umap-tier-migrator", daemon=True)
                self._tier_thread = t
                t.start()
        self._register_tier_collector(region, rid)
        self._install_breaker_hooks(region, rid)
        return rid

    def _install_breaker_hooks(self, region: "UMapRegion", rid: int) -> None:
        """Auto-recovery wiring (DESIGN.md §17.4): when a breaker on this
        region's store transitions back to CLOSED, quarantined pages get a
        fresh write-back budget — the store that failed them has provably
        recovered.  Listeners fire from I/O threads holding no shard locks
        (breaker transitions happen in ResilientStore._call, outside all
        pager locks), so the repost below respects the lock order."""
        from .resilient import iter_breakers
        hooks = []
        for br in iter_breakers(region.store):
            def on_edge(old, new, _region=region):
                if new == "closed" and not _region._closing:
                    try:
                        self.retry_quarantined(_region)
                    except Exception:   # noqa: BLE001 — recovery is best-effort
                        pass
            br.add_listener(on_edge)
            hooks.append((br, on_edge))
        if hooks:
            with self.lock:
                self._breaker_hooks[rid] = hooks

    def unregister(self, region: "UMapRegion") -> None:
        # Closing gate FIRST: new faults raise, queued fills are abandoned by
        # the fillers, so flush_region's drain below terminates and no fill
        # can re-install a page after the region is dropped (the seed had a
        # window where exactly that ghost install leaked a slot forever).
        region._closing = True
        try:
            self.flush_region(region, evict=True)
        finally:
            # Unregister even when the flush raises on quarantined pages
            # (§14.4): the error must reach the caller, but leaving the
            # region registered would leak it — and its owned service's
            # worker threads — forever.  Quarantined entries deliberately
            # keep their slots (stranded, visible in quarantined_pages).
            with self.lock:
                self._regions.pop(region.region_id, None)
                self._classifiers.pop(region.region_id, None)
                hooks = self._breaker_hooks.pop(region.region_id, [])
            for br, fn in hooks:
                br.remove_listener(fn)

    def close(self, join_timeout_s: float = 5.0) -> None:
        """Flush and stop the worker pools.

        ``join_timeout_s`` bounds BOTH the per-region flush drain and the
        worker joins: a store call stalled past the deadline (dead remote
        tier, ChaosStore latency spike) must not wedge shutdown.  Workers
        that outlive the bounded join are daemon threads — they are
        *leaked*, recorded in :attr:`leaked_threads`, and reported with a
        loud ``UserWarning`` naming each thread (DESIGN.md §17.7); the seed
        silently returned with the filler still blocked in the store.
        """
        if self._closed:
            return
        quarantine_err: Optional[BaseException] = None
        deadline = time.monotonic() + join_timeout_s
        for region in list(self._regions.values()):
            try:
                self.flush_region(region, evict=False, deadline=deadline)
            except IOError as e:
                # Best-effort shutdown: quarantined pages cannot be
                # persisted, but the worker pools must still come down.
                quarantine_err = e
        self._closed = True
        self.watermark.stop()
        self._fill_shutdown = True
        for cv in self._fill_cvs:
            with cv:
                cv.notify_all()
        for _ in self._evictors:
            self._clean_q.put(_SHUTDOWN)
        if self._tier_thread is not None:
            self._tier_stop = True
            with self._tier_cv:
                self._tier_cv.notify_all()
            self._tier_thread.join(timeout=join_timeout_s)
        for t in self._fillers + self._evictors:
            t.join(timeout=max(0.0, deadline - time.monotonic()) or 0.05)
        leaked = [t for t in self._fillers + self._evictors if t.is_alive()]
        if self._tier_thread is not None and self._tier_thread.is_alive():
            leaked.append(self._tier_thread)
        if leaked:
            self.leaked_threads.extend(t.name for t in leaked)
            warnings.warn(
                f"PagingService.close timed out after {join_timeout_s:.1f}s "
                f"waiting for in-flight store I/O; leaked daemon worker "
                f"thread(s): {', '.join(t.name for t in leaked)} — their "
                f"store calls are still running and will be abandoned",
                UserWarning, stacklevel=2)
        self.unregister_telemetry()
        if quarantine_err is not None:
            raise quarantine_err

    # --------------------------------------------------------- fault path

    def request_fills(self, region: "UMapRegion", page_nos: List[int],
                      demand: bool = True) -> None:
        """Post fill work for absent pages (no pinning, no waiting).

        Issuing all fills for a multi-page request up front keeps the filler
        pool busy (I/O overlap); the caller then pins/copies one page at a
        time via :meth:`acquire_one`, which bounds pins-per-thread to one and
        makes the pager deadlock-free under any buffer size.  Pages are
        posted in ascending order so adjacent fills stay adjacent in the
        routed deque (coalescing, DESIGN.md §9).
        """
        to_fill = self._insert_absent(region, page_nos, demand=demand)
        ra_fill = (self._post_readahead(region, page_nos)
                   if demand and region.readahead_pages > 0 else [])
        self._dispatch_fills(region, to_fill + ra_fill)
        if demand and to_fill:
            self._observe_faults(region, [e.key[1] for e in to_fill])

    def _insert_absent(self, region: "UMapRegion", page_nos: List[int],
                       demand: bool) -> List[PageEntry]:
        """Insert FILLING entries for the absent pages of ``page_nos``.

        One lock acquisition per touched stripe, not per page: under heavy
        thread counts every blocked acquire risks a full GIL switch
        interval, so the acquisition count is the latency budget.  Returns
        the new entries in ascending page order so adjacent fills stay
        adjacent in the routed deques (coalescing).
        """
        rid = region.region_id
        by_shard: Dict[int, List[int]] = {}
        for pno in page_nos:
            by_shard.setdefault(self._shard_index((rid, pno)), []).append(pno)
        out: List[PageEntry] = []
        for si, pnos in by_shard.items():
            shard = self.shards[si]
            with self._locked(shard):
                for pno in pnos:
                    key = (rid, pno)
                    if shard.table.get(key) is None:
                        e = shard.table.insert_filling(key)
                        if demand:
                            shard.counters["demand_faults"] += 1
                            if region.tiered and self._tier_thread is not None:
                                self._heat_locked(shard, region, pno)
                        else:
                            e.prefetched = True
                        out.append(e)
        out.sort(key=lambda e: e.key[1])
        return out

    def _heat_locked(self, shard: _Shard, region: "UMapRegion",
                     pno: int) -> None:
        """Bump the access heat of the store extent behind ``pno`` (shard
        lock held).  Demand faults only — a fault is a store read the fast
        tier could have absorbed, which is exactly the signal the migration
        engine ranks on (DESIGN.md §14.1); buffer hits cost no store I/O
        and would only promote extents the page buffer already serves."""
        key = (region.region_id,
               (pno * region.page_size) // region.store.extent_size)
        shard.heat[key] = shard.heat.get(key, 0.0) + 1.0

    def _wheat_locked(self, shard: _Shard, region: "UMapRegion",
                      pno: int) -> None:
        """Bump the write intensity of the store extent behind ``pno``
        (shard lock held).  Every dirty-mark is a future write-back the
        utility model must charge against migrating the extent — a hot
        *and* write-heavy extent that gets demoted pays a base-tier write
        the placement should have anticipated (DESIGN.md §14.5)."""
        key = (region.region_id,
               (pno * region.page_size) // region.store.extent_size)
        shard.wheat[key] = shard.wheat.get(key, 0.0) + 1.0

    def _note_write_locked(self, shard: _Shard, entry: PageEntry) -> None:
        """Write-intensity bump for call sites that only hold a PageEntry
        (shard lock held); resolves the region from the entry key."""
        rid, pno = entry.key
        region = self._regions.get(rid)
        if region is not None and region.tiered \
                and self._tier_thread is not None:
            self._wheat_locked(shard, region, pno)

    def _dispatch_fills(self, region: "UMapRegion",
                        entries: List[PageEntry]) -> None:
        if self.config.mmap_compat:
            for e in entries:
                self._do_fill(region, e, worker_id=-1)
        else:
            self._submit_fill_many(region, entries)

    def acquire_one(self, region: "UMapRegion", page_no: int,
                    lease: bool = False,
                    deadline: Optional[float] = None,
                    write_lease: bool = False,
                    exclude_writers: bool = False) -> Optional[PageEntry]:
        """Pin one page, faulting it in if needed (userfaultfd-style block).

        The caller must not hold any other pins (deadlock-freedom invariant;
        ``lease_run`` is the documented exception — it passes ``deadline``,
        a ``time.monotonic()`` bound past which this returns ``None`` so
        the run can abort-and-retry instead of deadlocking).  With
        ``lease=True`` the pin is accounted as a zero-copy lease
        (``entry.leases`` + the ``leases`` counter, DESIGN.md §13);
        ``write_lease`` additionally bumps ``entry.write_leases`` and
        ``exclude_writers`` bumps ``entry.excl_reads`` — the two sides of
        the snapshot/writer exclusion protocol (§18.4): a snapshot reader
        (``exclude_writers=True``) waits while write leases are live, and
        a write lease waits while snapshot readers are live.  Both waits
        ride ``shard.cond`` (notified on every lease release) and honor
        ``deadline``, so excluded ``lease_run`` grants abort-and-retry
        rather than deadlock.  Raises ``RuntimeError`` once the region has
        started closing — the guard that closes the flush/unregister
        re-install race — and ``IOError`` when the fill died on a
        backing-store exception (the error-propagation contract, DESIGN.md
        §14.4: every waiter raises, none re-faults forever).
        """
        key = (region.region_id, page_no)
        shard = self._shard_of(key)
        first_attempt = True
        while True:
            if region._closing:
                raise RuntimeError(
                    f"region {region.name or region.region_id} is closing")
            dispatch: Optional[PageEntry] = None
            waitee: Optional[PageEntry] = None
            with self._locked(shard):
                e = shard.table.get(key)
                if e is None:
                    e = shard.table.insert_filling(key)
                    shard.counters["demand_faults"] += 1
                    if region.tiered and self._tier_thread is not None:
                        self._heat_locked(shard, region, page_no)
                    dispatch = e
                    waitee = e
                elif e.state is PageState.PRESENT:
                    if lease and ((exclude_writers and e.write_leases > 0)
                                  or (write_lease and e.excl_reads > 0)):
                        # Excluded: wait for the opposing lease class to
                        # drain.  shard.cond wraps the shard lock, so the
                        # wait releases it; release_lease notify_all()s.
                        shard.counters["lease_excl_waits"] += 1
                        if deadline is not None \
                                and time.monotonic() >= deadline:
                            return None
                        shard.cond.wait(timeout=0.05)
                        first_attempt = False
                        continue
                    e.pins += 1
                    if lease:
                        e.leases += 1
                        if write_lease:
                            e.write_leases += 1
                        if exclude_writers:
                            e.excl_reads += 1
                        shard.counters["leases"] += 1
                    shard.policy.on_touch(key)
                    if first_attempt:
                        shard.counters["page_hits"] += 1
                    else:
                        shard.counters["wait_hits"] += 1
                    if e.prefetched and not e.touched_after_prefetch:
                        e.touched_after_prefetch = True
                        shard.counters["prefetch_hits"] += 1
                    return e
                else:  # FILLING / CLEANING / EVICTING
                    waitee = e
            if dispatch is not None:
                self._dispatch_fill(region, dispatch)
                self._observe_faults(region, [page_no])
            if deadline is not None and time.monotonic() >= deadline:
                return None        # dispatched fill proceeds; wait abandoned
            waitee.event.wait(timeout=0.05)
            if waitee.error is not None:
                raise IOError(
                    f"fill of page {page_no} in region "
                    f"{region.name or region.region_id} failed: "
                    f"{waitee.error}") from waitee.error
            first_attempt = False

    # Ceiling for the locked-copy fast path: a 64 KiB memcpy (~microseconds)
    # is cheaper than two extra contended acquisitions, but holding a stripe
    # lock across a multi-megabyte copy (UMAP_PAGESIZE reaches 8 MiB) would
    # serialize every fault on the stripe behind data movement — those
    # copies take the pinning path, which copies with no metadata lock held.
    LOCKED_COPY_MAX_BYTES = 64 * 1024

    def copy_page_out(self, region: "UMapRegion", page_no: int,
                      page_off: int, out) -> bool:
        """Fast read path: copy ``out.nbytes`` bytes from a PRESENT page
        under ONE stripe-lock acquisition.

        Replaces the pin → memcpy → release round-trip (three acquisitions)
        on the hit path: the page cannot be evicted mid-copy because the
        copy itself holds the stripe lock, and a small memcpy is far
        shorter than two extra contended acquisitions (large copies are
        refused — see ``LOCKED_COPY_MAX_BYTES``).  Returns False when the
        fast path does not apply — the caller falls back to the faulting
        :meth:`acquire_one` path.
        """
        if region._closing:
            return False      # acquire_one enforces the closing gate
        if out.nbytes > self.LOCKED_COPY_MAX_BYTES:
            return False
        key = (region.region_id, page_no)
        shard = self._shard_of(key)
        with self._locked(shard):
            e = shard.table.get(key)
            if e is None or e.state is not PageState.PRESENT:
                return False
            shard.policy.on_touch(key)
            shard.counters["page_hits"] += 1
            if e.prefetched and not e.touched_after_prefetch:
                e.touched_after_prefetch = True
                shard.counters["prefetch_hits"] += 1
            slot = self.buffer.slot_view(e.slot, self.buffer.slot_size)
            out[:] = slot[page_off : page_off + out.nbytes]
            return True

    def copy_page_in(self, region: "UMapRegion", page_no: int,
                     page_off: int, src) -> bool:
        """Fast write path: copy ``src`` into a PRESENT page and mark it
        dirty under ONE stripe-lock acquisition (see :meth:`copy_page_out`).
        The caller pokes the watermark monitor outside the lock."""
        if region._closing:
            return False      # acquire_one enforces the closing gate
        if src.nbytes > self.LOCKED_COPY_MAX_BYTES:
            return False
        key = (region.region_id, page_no)
        shard = self._shard_of(key)
        with self._locked(shard):
            e = shard.table.get(key)
            if e is None or e.state is not PageState.PRESENT:
                return False
            shard.policy.on_touch(key)
            shard.counters["page_hits"] += 1
            if e.prefetched and not e.touched_after_prefetch:
                e.touched_after_prefetch = True
                shard.counters["prefetch_hits"] += 1
            slot = self.buffer.slot_view(e.slot, self.buffer.slot_size)
            slot[page_off : page_off + src.nbytes] = src
            shard.table.mark_dirty(e)
            if region.tiered and self._tier_thread is not None:
                self._wheat_locked(shard, region, page_no)
            return True

    def _dispatch_fill(self, region: "UMapRegion", entry: PageEntry) -> None:
        if self.config.mmap_compat:
            self._do_fill(region, entry, worker_id=-1)
        else:
            self._submit_fill(region, entry)

    def release_one(self, entry: PageEntry) -> None:
        shard = self._shard_of(entry.key)
        with self._locked(shard):
            entry.pins -= 1
            assert entry.pins >= 0, f"pin underflow on {entry.key}"
            shard.cond.notify_all()

    def mark_dirty_one(self, entry: PageEntry) -> None:
        shard = self._shard_of(entry.key)
        with self._locked(shard):
            shard.table.mark_dirty(entry)
            self._note_write_locked(shard, entry)
        self.watermark.poke()

    # ------------------------------------------- zero-copy leases (DESIGN.md §13)

    def lease_page(self, region: "UMapRegion", page_no: int,
                   write: bool = False,
                   exclude_writers: bool = False,
                   _deadline: Optional[float] = None) -> Optional[PageLease]:
        """Lease one page: a pinned view directly into the page buffer.

        The pin rides ``entry.pins`` (plus the ``entry.leases`` lease count),
        so the page cannot be evicted or written back while the view is
        live; a write-lease marks the page dirty exactly once, on release.
        ``exclude_writers=True`` grants a *snapshot* read lease: the grant
        blocks while any write lease on the page is live, and write leases
        block while the snapshot is held (§18.4) — the consistency contract
        the async checkpointer relies on.  With
        ``config.zero_copy_leases=False`` the lease is copy-backed
        (private snapshot; see core/lease.py).  ``_deadline`` is
        ``lease_run``'s abort bound — past it the grant returns ``None``.
        """
        nbytes = region.page_nbytes(page_no)
        if not self.config.zero_copy_leases:
            data = region.read(page_no * region.page_size, nbytes)
            shard = self._shard_of((region.region_id, page_no))
            with self._locked(shard):
                shard.counters["leases"] += 1
            if not write:
                data.flags.writeable = False
            return PageLease(region, page_no, write, data, entry=None)
        entry = self.acquire_one(region, page_no, lease=True,
                                 deadline=_deadline, write_lease=write,
                                 exclude_writers=exclude_writers and not write)
        if entry is None:
            return None
        view = self.buffer.slot_view(entry.slot, nbytes)
        if not write:
            view = view[:]                   # fresh view object, shared memory
            view.flags.writeable = False
        return PageLease(region, page_no, write, view, entry,
                         exclusive=exclude_writers and not write)

    # Per-attempt grant bound for lease_run: long enough that any live
    # fill completes, short enough that an aborted attempt retries fast.
    _LEASE_RUN_ATTEMPT_S = 0.25

    def lease_run(self, region: "UMapRegion", first_page: int, npages: int,
                  write: bool = False,
                  exclude_writers: bool = False) -> LeaseRun:
        """Lease ``npages`` adjacent pages, posting all fills up front.

        Holds ``npages`` pins on the calling thread — the documented
        exception to the one-pin-per-thread invariant.  Two guards make
        that safe under ANY number of concurrent runs: the length cap
        ``min(config.max_lease_run, num_slots // 2)`` together with the
        stripe rule of :meth:`lease_run_limit` (a run past either raises
        ``ValueError`` at once: it could never be granted), and
        abort-and-retry — a grant that cannot
        complete within the attempt bound releases every pin the run
        holds and retries with jittered backoff, so incomplete runs never
        hold the slots other runs are waiting on (two-phase locking with
        abort, in place of a deadlock).
        """
        cap = max(1, min(self.config.max_lease_run,
                         self.buffer.num_slots // 2))
        if npages < 1 or npages > cap:
            raise ValueError(
                f"lease_run of {npages} pages outside [1, {cap}] "
                f"(max_lease_run={self.config.max_lease_run}, "
                f"{self.buffer.num_slots} slots)")
        fits = self.lease_run_limit(region, first_page, npages)
        if fits < npages:
            raise ValueError(
                f"lease_run of pages [{first_page}, {first_page + npages}) "
                f"puts more pages on one of the {len(self.shards)} metadata "
                f"stripes than it owns slots; only the first {fits} fit")
        pages = list(range(first_page, first_page + npages))
        attempt = 0
        while True:
            if self.config.zero_copy_leases:
                self.request_fills(region, pages)  # I/O overlap across the run
            deadline = time.monotonic() + self._LEASE_RUN_ATTEMPT_S
            leases: List[PageLease] = []
            try:
                for pno in pages:
                    ls = self.lease_page(region, pno, write=write,
                                         exclude_writers=exclude_writers,
                                         _deadline=deadline)
                    if ls is None:
                        break
                    leases.append(ls)
            except BaseException:
                for ls in leases:
                    ls.abandon()               # never handed out: no dirty mark
                raise
            if len(leases) == len(pages):
                return LeaseRun(leases)
            # Abort: free the slots peers are waiting on.  abandon(), not
            # release() — the views were never handed to the application,
            # so a write-mode abort must not mark untouched pages dirty.
            for ls in leases:
                ls.abandon()
            attempt += 1
            # Thread-dependent jitter breaks symmetric retry collisions.
            time.sleep(0.001 * (1 + (threading.get_ident() >> 4) % 7)
                       * min(attempt, 8))

    def lease_run_limit(self, region: "UMapRegion", first_page: int,
                        npages: int) -> int:
        """Pages of the run ``[first_page, first_page + npages)`` that
        ``lease_run`` can grant, counted from ``first_page``: at most the
        length cap, and no more pages on one metadata stripe than the
        stripe owns slots.  Page ``p`` lives on stripe ``hash((region, p))
        % stripes`` and a stripe only ever fills its own slots (buffer slot
        ``s`` belongs to stripe ``s % stripes``), so a run past this limit
        could never hold all its pins at once.  Callers cut their runs to
        it; ``lease_run`` refuses a run that exceeds it."""
        cap = max(1, min(self.config.max_lease_run,
                         self.buffer.num_slots // 2))
        stripes = len(self.shards)
        room = [len(range(i, self.buffer.num_slots, stripes))
                for i in range(stripes)]
        n = 0
        for pno in range(first_page, first_page + min(npages, cap)):
            i = self._shard_index((region.region_id, pno))
            if room[i] == 0:
                break
            room[i] -= 1
            n += 1
        return n

    def release_lease(self, entry: PageEntry, write: bool,
                      excl: bool = False,
                      dirty: Optional[bool] = None) -> None:
        """Drop a lease pin; a write-lease marks the page dirty here —
        exactly once, because PageLease.release is idempotent.  ``write``
        and ``excl`` must mirror the grant flags (they unwind the
        exclusion counters); ``dirty`` defaults to ``write`` and is forced
        False by ``PageLease.abandon`` — an aborted write grant must
        unwind ``write_leases`` without the spurious dirty mark."""
        if dirty is None:
            dirty = write
        shard = self._shard_of(entry.key)
        with self._locked(shard):
            entry.leases -= 1
            entry.pins -= 1
            if write:
                entry.write_leases -= 1
            if excl:
                entry.excl_reads -= 1
            assert (entry.pins >= 0 and entry.leases >= 0
                    and entry.write_leases >= 0 and entry.excl_reads >= 0), \
                f"lease underflow on {entry.key}"
            if dirty:
                shard.table.mark_dirty(entry)
                self._note_write_locked(shard, entry)
            shard.cond.notify_all()
        if dirty:
            self.watermark.poke()

    # ------------------------------------------- adaptive engine (DESIGN.md §8)

    def _observe_faults(self, region: "UMapRegion", page_nos: List[int]) -> None:
        """Feed demand-fault page numbers to the region's classifier.

        No-op unless ``config.adaptive`` and the region is not hint-pinned.
        Called outside the metadata locks (the classifier has its own); a
        confirmed phase transition retunes the region immediately.
        """
        clf = self._classifiers.get(region.region_id)
        if clf is None or region.hint_pinned:
            return
        decision = None
        for pno in page_nos:
            d = clf.observe(pno)
            if d is not None:
                decision = d
        if decision is not None:
            self._apply_decision(region, decision)

    def _apply_decision(self, region: "UMapRegion", decision) -> None:
        """Retune a region from a confirmed classifier decision.

        Re-checks pinning under the service lock: advise() may have pinned
        the region while this decision was in flight, and static hints must
        win even against a decision already computed.
        """
        with self.lock:
            if region.hint_pinned:
                return
            region.readahead_pages = decision.read_ahead
            region.detected_stride = decision.stride
            self._svc["pattern_transitions"] += 1
        self.set_eviction_policy(decision.eviction_policy)

    def set_eviction_policy(self, name: str) -> None:
        """Swap the eviction policy at runtime (adaptive engine / app call).

        Each shard gets a fresh policy instance that adopts that shard's
        currently-resident pages; recency history is intentionally dropped
        (the swap happens because the access pattern changed — see
        ``EvictionPolicy.adopt``).  Shards are swapped one at a time under
        their own locks (never two shard locks at once); the momentary
        cross-shard mix of old/new policy is harmless — victim choice is
        advisory, residency is not touched.
        """
        with self.lock:
            if name == self.shards[0].policy.name:
                return
            for shard in self.shards:
                with self._locked(shard):
                    new_policy = make_policy(name)
                    new_policy.adopt(shard.table.resident_keys())
                    shard.policy = new_policy

    def pattern_snapshot(self, region_id: int) -> Optional[dict]:
        """Telemetry: the classifier's current phase for one region."""
        clf = self._classifiers.get(region_id)
        return None if clf is None else clf.snapshot()

    # ----------------------------- tier migration engine (DESIGN.md §14)

    def apply_tier_hint(self, region: "UMapRegion", hint,
                        extents: List[int], level: int = 0) -> None:
        """Apply an application tier hint (``region.advise(tier_hint=...)``).

        Hints override heat, per the paper's application-knowledge-first
        design: ``hot`` seeds the extents with promote-threshold heat,
        ``pin_fast`` additionally pins them against demotion, ``cold``
        zeroes their heat and write intensity and queues demotion.
        ``level`` steers ``hot``/``pin_fast`` at a specific chain level
        (the ``"hot:1"`` / ``"pin_fast:2"`` forms, §14.4); the default is
        the fastest tier.  All migration I/O stays on the migration thread
        (poked here for promptness) — hints never charge the application
        thread a tier copy.
        """
        from .hints import TierHint
        hint = TierHint(hint)
        store = region.store
        rid = region.region_id
        if hint is TierHint.COLD:
            for shard in self.shards:
                with self._locked(shard):
                    for ext in extents:
                        shard.heat.pop((rid, ext), None)
                        shard.wheat.pop((rid, ext), None)
            with self._tier_cv:
                for ext in extents:
                    self._hot_targets.pop((rid, ext), None)
            store.mark_cold(extents)
        else:
            if hint is TierHint.PIN_FAST:
                store.pin_fast(extents, level=level)
            elif level > 0:
                # "hot:<level>" — remember the requested landing level so
                # the migration engine steers the copy mid-chain instead
                # of racing it to the fastest tier.
                with self._tier_cv:
                    for ext in extents:
                        self._hot_targets[(rid, ext)] = level
            # Seed heat in the extent's lead-page shard (aggregation sums
            # across shards, so one stripe carrying the boost suffices).
            boost = 2.0 * self.config.tier_promote_heat
            ps = region.page_size
            for ext in extents:
                key = (rid, ext)
                pno = (ext * store.extent_size) // ps
                shard = self._shard_of((rid, pno))
                with self._locked(shard):
                    shard.heat[key] = shard.heat.get(key, 0.0) + boost
        with self._tier_cv:
            self._tier_cv.notify_all()

    def _tier_loop(self) -> None:
        while True:
            with self._tier_cv:
                self._tier_cv.wait(timeout=self.config.tier_interval_s)
            if self._tier_stop:
                return
            try:
                self._tier_cycle()
            except Exception:       # store I/O died mid-migration: the
                self._svc["tier_errors"] += 1    # next cycle retries


    def _decay_heat(self) -> Tuple[Dict[tuple, float], Dict[tuple, float]]:
        """Decay every shard's heat + write-intensity counters and return
        the two aggregates ``(heat, wheat)``.

        Exponential decay (``heat *= tier_decay`` per cycle) keeps the
        ranking recency-weighted — an extent hot during warmup but idle
        since cools below the promote threshold within a few cycles.
        Sub-0.05 residue is dropped so idle tiered services converge to
        empty maps (zero steady-state cost).
        """
        decay = self.config.tier_decay
        agg: Dict[tuple, float] = {}
        wagg: Dict[tuple, float] = {}
        for shard in self.shards:
            with self._locked(shard):
                for counts, out in ((shard.heat, agg), (shard.wheat, wagg)):
                    dead = []
                    for k, v in counts.items():
                        v *= decay
                        if v < 0.05:
                            dead.append(k)
                        else:
                            counts[k] = v
                            out[k] = out.get(k, 0.0) + v
                    for k in dead:
                        del counts[k]
        return agg, wagg

    def _tier_cycle(self) -> None:
        """One migration pass, dispatched on ``config.tier_policy``.

        ``utility`` (default) ranks placements by sampled-latency benefit
        net of write-back cost (§14.5); ``heat`` is the legacy
        fault-count engine, kept for A/B comparison.  Transactional
        safety lives in the store either way (copy → verify gen → flip,
        §14.2): a promote/demote that races a write or an in-flight read
        returns False and is simply retried on a later cycle, so this loop
        never blocks a fault and never publishes a torn extent.
        """
        if self.config.tier_policy == "heat":
            self._tier_cycle_heat()
        else:
            self._tier_cycle_utility()
        self._svc["tier_cycles"] += 1

    def _tier_cycle_heat(self) -> None:
        """Legacy engine: promote by decayed fault count, demote coldest.

        Operates on the fastest level only (the historical two-tier
        behavior); deeper chain levels are touched only by demand-miss
        promotion inside the store.
        """
        heats, _ = self._decay_heat()
        with self.lock:
            regions = [r for r in self._regions.values()
                       if r.tiered and not r._closing]
        threshold = self.config.tier_promote_heat
        budget = self.config.tier_max_migrations
        promoted = demoted = 0
        for region in regions:
            store = region.store
            rid = region.region_id
            cold_hints = store.take_cold_hints()      # explicit cold advice
            for ext in cold_hints:
                if store.demote(ext):
                    demoted += 1
            if cold_hints:
                # A demote refused by a transient pin/gen race must not
                # lose the hint: re-queue whatever is STILL resident for
                # the next cycle (non-resident extents are done either way).
                still = set(store.resident_extents())
                missed = [e for e in cold_hints if e in still]
                if missed:
                    store.mark_cold(missed)
            resident = set(store.resident_extents())
            pinned = set(store.pinned_fast_extents())
            heat_of = {ext: v for (r, ext), v in heats.items() if r == rid}
            # pin_fast extents promote at top priority regardless of heat.
            hot = sorted((e for e in pinned if e not in resident),
                         key=lambda e: -heat_of.get(e, 0.0))
            hot += sorted(
                (e for e, v in heat_of.items()
                 if v >= threshold and e not in resident and e not in pinned),
                key=lambda e: -heat_of[e])
            cold = sorted((e for e in resident if e not in pinned),
                          key=lambda e: heat_of.get(e, 0.0))
            for ext in hot:
                if promoted >= budget:
                    break
                if store.free_fast_slots() == 0:
                    # Demote the coldest resident extent — but only with
                    # hysteresis (half the candidate's heat), so two
                    # equally-warm extents cannot ping-pong a slot.
                    victim = None
                    for c in cold:
                        if heat_of.get(c, 0.0) < 0.5 * heat_of.get(ext, threshold):
                            victim = c
                            break
                    if victim is None or not store.demote(victim):
                        continue
                    cold.remove(victim)
                    demoted += 1
                if store.promote(ext):
                    promoted += 1
        self._svc["tier_promotions"] += promoted
        self._svc["tier_demotions"] += demoted

    @staticmethod
    def tier_utility(heat: float, wheat: float, lat_from: float,
                     lat_to: float, wlat_base: float) -> float:
        """THE placement score (DESIGN.md §14.5), shared by candidate gain
        and resident hold value::

            utility = expected_accesses × sampled_latency_delta
                      − write_intensity × demote_cost

        ``lat_from`` is the level the extent would otherwise serve from,
        ``lat_to`` the level under consideration; the delta floors at 0
        (a slower placement never scores positive access benefit), and
        ``wlat_base`` prices the write-back a dirty extent eventually
        pays when displaced."""
        return heat * max(0.0, lat_from - lat_to) - wheat * wlat_base

    def _tier_cycle_utility(self) -> None:
        """Utility-driven engine over the whole chain (DESIGN.md §14.5).

        Scores a placement of extent ``e`` at cache level ``t`` as

            utility(e, t) = heat(e) × (rlat[fallback] − rlat[t])
                            − wheat(e) × wlat[base]

        where all latencies are the store's *online-sampled* per-op EWMAs
        (§14.3) — no configured tier speeds anywhere.  ``fallback`` is the
        level the extent would otherwise serve from: its current fastest
        copy for promotion candidates, the base tier for extents already
        resident at ``t`` (their hold value).  The write-intensity term
        charges the eventual demote write-back that placing a write-heavy
        extent in a cache tier commits to.  Per target level, fastest
        first: pinned/hint-targeted extents move unconditionally, then
        positive-utility candidates by descending score; a full level
        evicts its lowest-hold resident only when that hold is under
        ``tier_hysteresis ×`` the candidate's score (anti-ping-pong), and
        a displaced victim spills one level down-chain when that still
        carries utility — making the subsequent drop a free shadow flip
        (§14.2).  An unsampled source tier reads as latency 0.0; such
        extents promote optimistically (heat ≥ threshold) so a cold-start
        chain can calibrate itself from the migration traffic.
        """
        heats, wheats = self._decay_heat()
        with self.lock:
            regions = [r for r in self._regions.values()
                       if r.tiered and not r._closing]
        threshold = self.config.tier_promote_heat
        hyst = self.config.tier_hysteresis
        budget = self.config.tier_max_migrations
        promoted = demoted = 0
        for region in regions:
            store = region.store
            rid = region.region_id
            base = store.base_level
            # --- explicit cold advice drains first (app knowledge wins)
            cold_hints = store.take_cold_hints()
            for ext in cold_hints:
                while store.demote(ext):       # drop every cache copy
                    demoted += 1
            if cold_hints:
                still = set()
                for lvl in range(base):
                    still.update(store.resident_extents(lvl))
                missed = [e for e in cold_hints if e in still]
                if missed:                     # pin/gen race: re-queue
                    store.mark_cold(missed)
            # --- observed tier speeds (never configured, §14.3)
            rlat = [store.sampled_latency(lvl, "read")
                    for lvl in range(base + 1)]
            wlat_base = store.sampled_latency(base, "write")
            heat_of = {e: v for (r, e), v in heats.items() if r == rid}
            wheat_of = {e: v for (r, e), v in wheats.items() if r == rid}
            pins = store.pin_levels()
            with self._tier_cv:
                stale = [k for k in self._hot_targets
                         if k[0] == rid and k[1] not in heat_of]
                for k in stale:                # hint died with its heat
                    del self._hot_targets[k]
                targets = {e: lvl for (r, e), lvl in
                           self._hot_targets.items() if r == rid}
            level_of: Dict[int, int] = {}      # fastest cached copy
            for lvl in range(base - 1, -1, -1):
                for e in store.resident_extents(lvl):
                    level_of[e] = lvl
            cand = (set(heat_of) | set(wheat_of) | set(pins)
                    | set(targets) | set(level_of))

            def gain(e: int, t: int) -> float:
                return self.tier_utility(
                    heat_of.get(e, 0.0), wheat_of.get(e, 0.0),
                    rlat[level_of.get(e, base)], rlat[t], wlat_base)

            def hold(e: int, t: int) -> float:
                return self.tier_utility(
                    heat_of.get(e, 0.0), wheat_of.get(e, 0.0),
                    rlat[base], rlat[t], wlat_base)

            for t in range(base):
                if promoted >= budget:
                    break
                first = [e for e in cand
                         if level_of.get(e, base) > t
                         and (pins.get(e) == t or targets.get(e) == t)]
                first.sort(key=lambda e: -heat_of.get(e, 0.0))
                forced = set(first)
                rest = []
                for e in cand:
                    if e in forced or level_of.get(e, base) <= t:
                        continue
                    if e in pins or e in targets:
                        continue               # steered to another level
                    g = gain(e, t)
                    unsampled = rlat[level_of.get(e, base)] == 0.0
                    if g > 0.0 or (unsampled
                                   and heat_of.get(e, 0.0) >= threshold):
                        rest.append((g, e))
                rest.sort(key=lambda p: -p[0])
                for ext in first + [e for _, e in rest]:
                    if promoted >= budget:
                        break
                    if store.free_slots(t) == 0:
                        g = gain(ext, t)
                        score = max(g, hold(ext, t)) if ext in forced else g
                        # hold() is monotone, so if the lowest-hold resident
                        # fails the hysteresis bar nobody passes it.
                        victim = None
                        vics = [v for v in store.resident_extents(t)
                                if v not in pins and v != ext]
                        if vics:
                            v0 = min(vics, key=lambda v: hold(v, t))
                            if hold(v0, t) < hyst * score:
                                victim = v0
                        if victim is None:
                            continue
                        nxt = t + 1
                        if (nxt < base and store.free_slots(nxt) > 0
                                and hold(victim, nxt) > 0.0):
                            store.promote(victim, nxt)   # spill down-chain
                        if not store.demote(victim, t):
                            continue
                        demoted += 1
                        level_of.pop(victim, None)
                        for lvl in range(base):
                            if victim in store.resident_extents(lvl):
                                level_of[victim] = lvl
                                break
                    if store.promote(ext, t):
                        promoted += 1
                        level_of[ext] = min(level_of.get(ext, base), t)
                        if targets.get(ext) == t:
                            with self._tier_cv:
                                self._hot_targets.pop((rid, ext), None)
            # publish aggregate hold utility per level for telemetry
            agg = [0.0] * (base + 1)
            for lvl in range(base):
                for e in store.resident_extents(lvl):
                    agg[lvl] += max(0.0, hold(e, lvl))
            store.note_utility(agg)
        self._svc["tier_promotions"] += promoted
        self._svc["tier_demotions"] += demoted

    # ------------------------------------------------------ prefetch (§3.6)

    def prefetch(self, region: "UMapRegion", page_nos: List[int]) -> int:
        """App-driven prefetch of an *arbitrary* page set (paper §3.6)."""
        to_fill = self._insert_absent(region, page_nos, demand=False)
        self._dispatch_fills(region, to_fill)
        return len(to_fill)

    def _post_readahead(self, region: "UMapRegion", faulted: List[int]) -> List[PageEntry]:
        """Window readahead past demand faults (UMAP_READ_AHEAD).

        Stride-aware: when the adaptive classifier detected a non-unit
        stride, the window is posted *along that stride* (pages ``base +
        k*stride``) — prefetch a static advice vocabulary cannot express.
        Negative strides (backward scans) read ahead *downward* from the
        lowest faulted page.  Returns the new entries for the caller to
        dispatch.
        """
        npages = region.num_pages
        stride = getattr(region, "detected_stride", 1) or 1
        base = min(faulted) if stride < 0 else max(faulted)
        out: List[PageEntry] = []
        for k in range(1, region.readahead_pages + 1):
            pno = base + k * stride
            if not (0 <= pno < npages):
                break
            key = (region.region_id, pno)
            shard = self._shard_of(key)
            with self._locked(shard):
                if shard.table.get(key) is None:
                    e = shard.table.insert_filling(key)
                    e.prefetched = True
                    out.append(e)
        return out

    # ------------------------------- fill queues + work stealing (§3.3)

    def _submit_fill(self, region: "UMapRegion", entry: PageEntry) -> None:
        self._submit_fill_many(region, [entry])

    def _submit_fill_many(self, region: "UMapRegion",
                          entries: List[PageEntry]) -> None:
        """Route fill work to filler deques by coalescing granule.

        Adjacent pages (same ``max_batch_pages`` granule) land on the same
        deque, so the owning filler can drain them as one batched store
        read; distinct granules spread across the pool for I/O overlap.
        Each routed deque is touched under ITS OWN condition — there is no
        global queue lock to re-centralize the contention the metadata
        shards remove.
        """
        if not entries:
            return
        granule = max(1, self.config.max_batch_pages)
        nq = len(self._fill_qs)
        rid = region.region_id
        # The 3-tuple salt keeps deque routing decorrelated from metadata
        # sharding (hash((rid, pno)) % N): with num_fillers == shards an
        # unsalted route would statically bind each filler to one stripe.
        by_route: Dict[int, List[_FillWork]] = {}
        for entry in entries:
            route = hash((rid, entry.key[1] // granule, "route")) % nq
            by_route.setdefault(route, []).append(_FillWork(region, entry))
        for route, works in by_route.items():
            cv = self._fill_cvs[route]
            with cv:
                self._fill_qs[route].extend(works)
                cv.notify()
        # Telemetry-only racy read: exact tracking would need a global lock.
        depth = sum(len(q) for q in self._fill_qs)
        if depth > self._svc["fill_queue_peak"]:
            self._svc["fill_queue_peak"] = depth

    def _steal(self, worker_id: int) -> bool:
        """Steal ~half the busiest peer's deque into our own.

        Called holding NO deque locks: the victim's condition and our own
        are taken one after the other (never nested), so steal paths cannot
        deadlock.  The tail of the victim's deque is taken (the owner
        consumes from the head, so a batch it may be coalescing is left
        alone) and order is preserved, keeping stolen runs coalescible by
        the thief.  ``len(deque)`` reads are GIL-atomic — a stale scan just
        means a failed steal attempt.
        """
        victim_id = -1
        victim_len = 1        # require >= 2: a lone item belongs to its owner
        for i, q in enumerate(self._fill_qs):
            if i != worker_id and len(q) > victim_len:
                victim_id, victim_len = i, len(q)
        if victim_id < 0:
            # Desperation pass: any single queued item is better than idling.
            for i, q in enumerate(self._fill_qs):
                if i != worker_id and len(q) > 0:
                    victim_id = i
                    break
            if victim_id < 0:
                return False
        vq = self._fill_qs[victim_id]
        stolen: List[_FillWork] = []
        with self._fill_cvs[victim_id]:
            k = max(1, len(vq) // 2)
            for _ in range(min(k, len(vq))):
                stolen.append(vq.pop())
        if not stolen:
            return False
        stolen.reverse()
        with self._fill_cvs[worker_id]:
            self._fill_qs[worker_id].extend(stolen)
        # Single-writer counters (this filler only): race-free by ownership.
        self._per_filler_steals[worker_id] = \
            self._per_filler_steals.get(worker_id, 0) + 1
        self._per_filler_stolen[worker_id] = \
            self._per_filler_stolen.get(worker_id, 0) + len(stolen)
        return True

    def _drain_run(self, dq: deque, seed_work: _FillWork,
                   limit: int) -> List[PageEntry]:
        """Drain pending fills adjacent to the seed from the owner's deque.

        Scans a bounded prefix of the deque for same-region pages within
        ``limit`` of the seed, keeps the maximal contiguous run containing
        the seed, and puts everything else back in order.  Called with
        the owner's deque condition held; returns the run sorted by page
        number.
        """
        region = seed_work.region
        seed = seed_work.entry.key[1]
        lo, hi = seed - limit, seed + limit
        by_pno: Dict[int, _FillWork] = {}
        kept: List[_FillWork] = []
        scanned = 0
        while dq and scanned < 4 * limit:
            w = dq.popleft()
            scanned += 1
            pno = w.entry.key[1]
            if w.region is region and lo <= pno <= hi and pno not in by_pno:
                by_pno[pno] = w
            else:
                kept.append(w)
        run = [seed_work.entry]
        p = seed + 1
        while p in by_pno and len(run) < limit:
            run.append(by_pno.pop(p).entry)
            p += 1
        back: List[PageEntry] = []
        p = seed - 1
        while p in by_pno and len(run) + len(back) < limit:
            back.append(by_pno.pop(p).entry)
            p -= 1
        kept.extend(by_pno.values())
        dq.extendleft(reversed(kept))
        return list(reversed(back)) + run

    def _take_unit(self, dq: deque, work: _FillWork):
        """One unit of fill work: the seed plus its coalescible run (called
        with the owner's deque condition held)."""
        limit = min(self.config.max_batch_pages,
                    getattr(work.region.store, "batch_read_hint", 1))
        if limit > 1 and work.region.fill_callback is None:
            return work.region, self._drain_run(dq, work, limit)
        return work.region, [work.entry]

    # Units a filler pops per deque acquisition: amortizes the deque lock
    # when coalescing cannot (max_batch_pages=1 / tiny store hints) while
    # staying small enough that work stealing keeps the pool balanced.
    _POP_UNITS = 4

    def _filler_loop(self, worker_id: int) -> None:
        dq = self._fill_qs[worker_id]
        cv = self._fill_cvs[worker_id]
        # Steal-rescan backoff: submissions notify the routed owner directly,
        # so the timeout only bounds how fast an idle filler notices a BUSY
        # peer's backlog.  It decays toward 10 ms while work is around and
        # backs off to 0.5 s when the pool is truly idle — a parked idle
        # pool costs ~2 wakes/s/filler instead of 100.
        idle_wait = 0.01
        while True:
            units: List = []
            while not units:
                with cv:
                    if not dq and not self._fill_shutdown:
                        # Owner notification or steal-rescan timeout.
                        cv.wait(timeout=idle_wait)
                    while dq and len(units) < self._POP_UNITS:
                        units.append(self._take_unit(dq, dq.popleft()))
                if units:
                    idle_wait = 0.01
                    break
                if self._steal(worker_id):
                    idle_wait = 0.01
                    continue          # stolen work landed in our deque
                if self._fill_shutdown:
                    return
                idle_wait = min(idle_wait * 2, 0.5)
            for region, entries in units:
                try:
                    if region._closing:
                        self._abandon_fills(entries)
                    elif len(entries) == 1:
                        self._do_fill(region, entries[0], worker_id)
                    else:
                        self._do_fill_batch(region, entries, worker_id)
                except Exception as exc:  # keep the pool alive; the seed's
                    # print_exc + abandon here was the infinite-re-fault bug
                    # (DESIGN.md §14.4): store exceptions are now handled
                    # inside _do_fill/_do_fill_batch with slot cleanup, so
                    # only unexpected engine errors reach this — propagate
                    # them to the fault site too rather than re-faulting.
                    self._fail_fills(entries, exc)

    def _abandon_fills(self, entries: List[PageEntry]) -> None:
        """Drop FILLING entries (closing region): waiters wake and observe
        the closing gate.

        Grouped per shard — ONE lock acquisition and ONE broadcast per
        touched stripe, matching the ``_insert_absent`` discipline — so a
        batch spanning several stripes wakes every stripe's waiters (the
        §14.4 audit: the per-entry loop this replaces did notify each
        entry's own stripe, but re-acquired the same lock once per entry;
        the regression test pins the all-stripes wakeup either way).
        """
        by_shard: Dict[int, List[PageEntry]] = {}
        for e in entries:
            by_shard.setdefault(self._shard_index(e.key), []).append(e)
        for si, es in by_shard.items():
            shard = self.shards[si]
            with self._locked(shard):
                for e in es:
                    if (shard.table.get(e.key) is e
                            and e.state is PageState.FILLING):
                        shard.table.remove(e)
                    else:
                        e.event.set()
                shard.cond.notify_all()

    def _fail_fills(self, entries: List[PageEntry], exc: BaseException) -> None:
        """Fail FILLING entries on a store exception (DESIGN.md §14.4).

        The error is stashed on each entry *before* its event is set, so
        every thread blocked in :meth:`acquire_one` observes it on wake and
        raises ``IOError`` — no waiter is left to re-fault forever.  The
        entries leave the table, so a *later* fault is a fresh attempt
        against the store (the application's retry path).
        """
        by_shard: Dict[int, List[PageEntry]] = {}
        for e in entries:
            by_shard.setdefault(self._shard_index(e.key), []).append(e)
        for si, es in by_shard.items():
            shard = self.shards[si]
            with self._locked(shard):
                for e in es:
                    e.error = exc
                    shard.counters["io_errors"] += 1
                    if (shard.table.get(e.key) is e
                            and e.state is PageState.FILLING):
                        shard.table.remove(e)    # sets the event
                    else:
                        e.event.set()
                shard.cond.notify_all()

    def _release_fill_slots(self, pairs) -> None:
        """Return never-installed slots of a failed fill to their shards."""
        for e, slot in pairs:
            shard = self._shard_of(e.key)
            with self._locked(shard):
                self.buffer.release(slot)
                shard.free.append(slot)
                shard.cond.notify_all()

    def _io_retry(self, op):
        """Route a store call through the retry policy (DESIGN.md §17.3).

        With ``config.resilient_io`` the fill/write-back paths no longer
        raise on first failure: transient errors (see
        ``resilient.default_classify``) retry with exponential backoff +
        jitter under ``retry_deadline_s``.  Crucially this includes
        ``BreakerOpenError`` from a wrapped tier — a retry *re-plans* the
        tiered routing, which is the transparent fast-tier failover path
        while a breaker is open.  Off (the default): the PR 5 fail-fast
        contract is unchanged.
        """
        cfg = self.config
        if not cfg.resilient_io:
            return op()
        from .resilient import default_classify
        deadline = time.monotonic() + cfg.retry_deadline_s
        sleep = cfg.retry_backoff_s
        attempt = 0
        while True:
            try:
                return op()
            except Exception as exc:        # noqa: BLE001 — classified below
                attempt += 1
                if (not default_classify(exc) or attempt > cfg.io_retries
                        or time.monotonic() + sleep >= deadline):
                    raise
                time.sleep(sleep * (1.0 + 0.5 * random.random()))
                sleep = min(sleep * 2, cfg.retry_max_backoff_s)

    # ------------------------------------------ fill resolution (read path)

    def _do_fill_batch(self, region: "UMapRegion", entries: List[PageEntry],
                       worker_id: int) -> None:
        """Resolve a run of adjacent pages with ONE batched store read.

        Slot allocation never *waits* while the batch holds un-installed
        slots (only the first allocation may block — the filler holds
        nothing yet); entries that cannot get a slot immediately are
        requeued as single fills, preserving the pager's deadlock-freedom
        argument.  Installs are grouped per shard, waking every blocked
        faulting thread of the run (batched UFFDIO_COPY semantics).
        """
        slots = [self._alloc_slot_blocking(entries[0].key)]
        for e in entries[1:]:
            slot = self._try_alloc_slot(e.key)
            if slot is None:
                break
            slots.append(slot)
        taken = len(slots)
        for e in entries[taken:]:                # memory pressure: retry singly
            self._submit_fill(region, e)
        entries = entries[:taken]

        bufs = [
            self.buffer.slot_view(slot, region.page_nbytes(e.key[1]))
            for e, slot in zip(entries, slots)
        ]
        # ONE store call for the whole run — I/O outside all locks.  A store
        # exception fails the whole run: slots go back to their shards and
        # every fault waiter raises IOError (DESIGN.md §14.4).
        try:
            self._io_retry(lambda: region.store.read_into_batch(
                entries[0].key[1] * region.page_size, bufs))
        except Exception as exc:
            self._release_fill_slots(zip(entries, slots))
            self._fail_fills(entries, exc)
            return

        seed_si = self._shard_index(entries[0].key)
        groups: Dict[int, List] = {}
        for e, slot in zip(entries, slots):
            groups.setdefault(self._shard_index(e.key), []).append((e, slot))
        for si, pairs in groups.items():
            shard = self.shards[si]
            with self._locked(shard):
                for e, slot in pairs:
                    shard.table.install(e, slot)
                    shard.policy.on_install(e.key)
                    if e.prefetched:
                        shard.counters["prefetch_fills"] += 1
                if si == seed_si and len(entries) > 1:
                    shard.counters["coalesced_fills"] += 1
                    shard.counters["coalesced_pages"] += len(entries)
                shard.cond.notify_all()
        if worker_id >= 0:
            pf = self._per_filler_fills
            pf[worker_id] = pf.get(worker_id, 0) + len(entries)

    def _do_fill(self, region: "UMapRegion", entry: PageEntry, worker_id: int) -> None:
        if self._mmap_sem is not None:
            with self._mmap_sem:
                self._do_fill_inner(region, entry, worker_id)
        else:
            self._do_fill_inner(region, entry, worker_id)

    def _do_fill_inner(self, region: "UMapRegion", entry: PageEntry,
                       worker_id: int) -> None:
        if region._closing:
            self._abandon_fills([entry])
            return
        slot = self._alloc_slot_blocking(entry.key)
        nbytes = region.page_nbytes(entry.key[1])
        buf = self.buffer.slot_view(slot, self.buffer.slot_size)
        # I/O outside all locks.  On a store/callback exception the slot is
        # returned and the error propagates to every waiter (§14.4).
        try:
            if region.fill_callback is not None:
                region.fill_callback(entry.key[1], buf[:nbytes])
            else:
                self._io_retry(lambda: region.store.read_into(
                    entry.key[1] * region.page_size, buf[:nbytes]))
        except Exception as exc:
            self._release_fill_slots([(entry, slot)])
            self._fail_fills([entry], exc)
            return
        shard = self._shard_of(entry.key)
        with self._locked(shard):
            shard.table.install(entry, slot)
            shard.policy.on_install(entry.key)
            if entry.prefetched:
                shard.counters["prefetch_fills"] += 1
            shard.cond.notify_all()
        if worker_id >= 0:
            pf = self._per_filler_fills
            pf[worker_id] = pf.get(worker_id, 0) + 1

    # ------------------------------------------------- slot allocation

    def _shard_try_alloc(self, shard: _Shard, key: PageKey) -> Optional[int]:
        """Pop a free slot from the shard's pool (shard lock held)."""
        if not shard.free:
            return None
        slot = shard.free.pop()
        self.buffer.claim(slot, key)
        return slot

    def _clean_victim_ok(self, shard: _Shard, key: PageKey) -> bool:
        e = shard.table.get(key)
        if e is None or e.state is not PageState.PRESENT:
            return False
        if e.pins > 0:
            if e.leases > 0:      # capacity pressure blocked by a live lease
                shard.counters["lease_blocked_evictions"] += 1
            return False
        return not e.dirty

    def _any_victim_ok(self, shard: _Shard, key: PageKey) -> bool:
        e = shard.table.get(key)
        if e is None or e.state is not PageState.PRESENT:
            return False
        if e.pins > 0:
            if e.leases > 0:
                shard.counters["lease_blocked_evictions"] += 1
            return False
        # A quarantined page's only copy of its dirty bytes is the buffer
        # slot — evicting it would be silent data loss (§14.4).
        return not e.quarantined

    def _drop_clean(self, shard: _Shard, entry: PageEntry) -> None:
        """Evict a clean victim — pure metadata, no I/O (shard lock held)."""
        self.buffer.release(entry.slot)
        shard.free.append(entry.slot)
        shard.table.remove(entry)            # sets event: waiters re-fault
        shard.counters["evictions"] += 1
        shard.cond.notify_all()

    def _post_shard_clean_locked(self, shard: _Shard, max_pages: int) -> int:
        """Queue up to ``max_pages`` of this shard's dirty pages for cleaning
        (shard lock held) — the filler→cleaner backpressure edge."""
        posted = 0
        for key in shard.table.resident_keys():
            e = shard.table.get(key)
            if (e is None or not e.dirty or e.state is not PageState.PRESENT
                    or e.quarantined):
                continue
            if e.pins > 0:
                if e.leases > 0:      # dirty but lease-pinned: repost later
                    shard.counters["lease_blocked_evictions"] += 1
                continue
            e.state = PageState.CLEANING
            e.event.clear()
            self._clean_q.put(("clean", e))
            posted += 1
            if posted >= max_pages:
                break
        return posted

    def _alloc_slot_blocking(self, key: PageKey) -> int:
        """Get a slot in ``key``'s shard, evicting clean victims when full.

        Read/write decoupling (DESIGN.md §12): on the UMap path this never
        performs write-back — clean victims are dropped inline (no I/O) and,
        when only dirty pages remain, they are posted to the cleaner queue
        and the filler waits on the shard condition until an evictor has
        cleaned them.  Only ``mmap_compat`` keeps the kernel's coupled
        behavior (synchronous write-back on the fault path).  May block, so
        callers must hold no un-installed slots (deadlock-freedom).
        """
        shard = self._shard_of(key)
        inline_writeback = self.config.mmap_compat
        while True:
            victim: Optional[PageEntry] = None
            with self._locked(shard):
                slot = self._shard_try_alloc(shard, key)
                if slot is not None:
                    return slot
                # Under pressure, write-back follows eviction order: if the
                # policy's PREFERRED victim is dirty, hand it to the
                # cleaners now — even when a clean page lets the fill
                # proceed — so a dirty page cannot outlive arbitrary
                # capacity churn un-persisted (the seed's dirty-eviction
                # semantics, minus the filler doing the write).  CLEANING
                # state prevents reposting.
                if not inline_writeback:
                    top = shard.policy.pick_victims(
                        1, lambda k: self._any_victim_ok(shard, k))
                    if top:
                        e0 = shard.table.get(top[0])
                        if e0 is not None and e0.dirty and not e0.quarantined \
                                and e0.state is PageState.PRESENT:
                            e0.state = PageState.CLEANING
                            e0.event.clear()
                            self._clean_q.put(("clean", e0))
                while True:                       # clean-drop/alloc under ONE hold
                    victims = shard.policy.pick_victims(
                        1, lambda k: self._clean_victim_ok(shard, k))
                    if not victims:
                        break
                    e = shard.table.get(victims[0])
                    shard.policy.on_remove(e.key)
                    self._drop_clean(shard, e)
                    slot = self._shard_try_alloc(shard, key)
                    if slot is not None:
                        return slot
                if inline_writeback:
                    victims = shard.policy.pick_victims(
                        1, lambda k: self._any_victim_ok(shard, k))
                    if victims:
                        victim = shard.table.get(victims[0])
                        victim.state = PageState.EVICTING
                        victim.event.clear()
                        shard.policy.on_remove(victim.key)
                    else:
                        shard.cond.wait(timeout=0.1)
                        continue
                else:
                    # Only dirty/pinned/in-flight pages left: hand dirty ones
                    # to the cleaners and wait — the read path does not write.
                    posted = self._post_shard_clean_locked(shard, max_pages=4)
                    # Every slot of the stripe held by a quarantined page
                    # (a write-back that failed after the last
                    # retry_quarantined) is a wait nothing serves: no
                    # cleaner or eviction touches them.  Fail the fill
                    # instead; its faulting thread raises IOError and can
                    # re-post the quarantine and retry.
                    owned = len(range(shard.index, self.buffer.num_slots,
                                      len(self.shards)))
                    if not posted and sum(
                            1 for k in shard.table.resident_keys()
                            if shard.table.get(k).quarantined) >= owned:
                        raise IOError(
                            f"every slot of stripe {shard.index} holds a "
                            f"quarantined dirty page; retry_quarantined() "
                            f"once the store is back")
                    shard.counters["fill_stalls"] += 1
                    shard.cond.wait(timeout=0.05)
                    continue
            if victim is not None:               # mmap baseline only
                self._evict_now(victim)

    def _try_alloc_slot(self, key: PageKey) -> Optional[int]:
        """Non-blocking slot allocation: drop clean victims, never wait,
        never write (batch-fill extras; deadlock-freedom invariant)."""
        shard = self._shard_of(key)
        with self._locked(shard):
            while True:
                slot = self._shard_try_alloc(shard, key)
                if slot is not None:
                    return slot
                victims = shard.policy.pick_victims(
                    1, lambda k: self._clean_victim_ok(shard, k))
                if not victims:
                    return None
                e = shard.table.get(victims[0])
                shard.policy.on_remove(e.key)
                self._drop_clean(shard, e)

    # ------------------------------------------------ write path (cleaners)

    def _evict_now(self, victim: PageEntry) -> None:
        """Write back (if dirty) and free the victim's slot.  No locks held.

        Runs on evictor threads, the flush path, or the mmap baseline's
        faulting thread — never on a UMap filler (read/write decoupling).
        """
        self._evict_now_batch([victim])

    def _writeback_runs(self, pairs):
        """Group (region, entry) pairs into adjacent same-region runs.

        Each yielded run is written with ONE ``write_from_batch`` call;
        run length is capped at ``min(max_writeback_batch,
        store.batch_write_hint)``.  Sorting by (region, page) here is what
        turns an arbitrary cleaner-queue drain into sequential store writes.
        """
        pairs = sorted(pairs, key=lambda p: (p[1].key[0], p[1].key[1]))
        run: List[PageEntry] = []
        run_region = None
        for region, e in pairs:
            limit = max(1, min(self.config.max_writeback_batch,
                               getattr(region.store, "batch_write_hint", 1)))
            if (run and (region is not run_region
                         or e.key[1] != run[-1].key[1] + 1
                         or len(run) >= limit)):
                yield run_region, run
                run = []
            run_region = region
            run.append(e)
        if run:
            yield run_region, run

    def _write_run(self, region: "UMapRegion", run: List[PageEntry]) -> None:
        """ONE store write for an adjacent run — I/O outside all locks —
        then per-shard atomic clean-bit clearing + waiter wakeup."""
        bufs = [self.buffer.slot_view(e.slot, region.page_nbytes(e.key[1]))
                for e in run]
        if len(run) == 1:
            self._io_retry(lambda: region.store.write_from(
                run[0].key[1] * region.page_size, bufs[0]))
        else:
            self._io_retry(lambda: region.store.write_from_batch(
                run[0].key[1] * region.page_size, bufs))

    def _evictor_loop(self, worker_id: int) -> None:
        # Opportunistic batch drain: after blocking on the first item, pull
        # whatever else is already queued (bounded) so adjacent dirty pages
        # posted by the watermark/backpressure paths coalesce into batched
        # store writes instead of one syscall-equivalent per page.
        drain = 4 * max(1, self.config.max_writeback_batch)
        while True:
            work = self._clean_q.get()
            if work is _SHUTDOWN:
                return
            items = [work]
            swallowed_shutdown = False
            while len(items) < drain:
                try:
                    nxt = self._clean_q.get_nowait()
                except queue.Empty:
                    break
                if nxt is _SHUTDOWN:
                    swallowed_shutdown = True    # re-posted below
                    break
                items.append(nxt)
            try:
                # Every queued payload is ("clean", entry) — eviction goes
                # through _evict_now_batch directly, never this queue.
                self._do_clean_batch([e for _, e in items])
            except Exception as exc:  # pragma: no cover - engine bug; store
                # errors are handled inside _do_clean_batch.  The seed's
                # print_exc here stranded CLEANING pages forever (§14.4);
                # route survivors through the bounded retry/quarantine path.
                self._fail_writeback(
                    [e for _, e in items
                     if e.state is PageState.CLEANING], exc, evicting=False)
            if swallowed_shutdown:
                self._clean_q.put(_SHUTDOWN)

    def _do_clean(self, entry: PageEntry) -> None:
        """Write a dirty page back to its store; page stays resident."""
        self._do_clean_batch([entry])

    def _do_clean_batch(self, entries: List[PageEntry]) -> None:
        """Write dirty pages back, coalescing adjacent pages per region.

        Dequeue-time re-validation (under each page's stripe lock) is the
        pinned-write-back fix: a page that picked up a pin — e.g. a
        zero-copy lease — after it was posted to the cleaner queue must NOT
        be written back mid-mutation.  Such pages revert to PRESENT (still
        dirty); the watermark reposts them once the pin drops.  Validated
        pages stay CLEANING, which no path can pin, so their bytes are
        stable for the batched write below.
        """
        valid: List = []
        for e in entries:
            region = self._regions.get(e.key[0])
            shard = self._shard_of(e.key)
            with self._locked(shard):
                if shard.table.get(e.key) is not e:
                    e.event.set()                 # removed mid-flight
                    shard.cond.notify_all()
                    continue
                if region is None:                # unregistered mid-flight
                    self.buffer.release(e.slot)
                    shard.free.append(e.slot)
                    shard.table.remove(e)
                    shard.cond.notify_all()
                    continue
                if e.state is not PageState.CLEANING:
                    e.event.set()                 # handled elsewhere (flush)
                    shard.cond.notify_all()
                    continue
                if e.pins > 0:
                    # The satellite fix: posted clean, pinned since.
                    e.state = PageState.PRESENT
                    e.event.set()
                    if e.leases > 0:
                        shard.counters["lease_blocked_evictions"] += 1
                    shard.cond.notify_all()
                    continue
                valid.append((region, e))
        for region, run in self._writeback_runs(valid):
            try:
                self._write_run(region, run)      # I/O outside all locks
            except Exception as exc:
                self._fail_writeback(run, exc, evicting=False)
                continue
            groups: Dict[int, List[PageEntry]] = {}
            for e in run:
                groups.setdefault(self._shard_index(e.key), []).append(e)
            seed_si = self._shard_index(run[0].key)
            for si, es in groups.items():
                shard = self.shards[si]
                with self._locked(shard):
                    for e in es:
                        if e.state is PageState.CLEANING:
                            e.state = PageState.PRESENT
                        shard.table.mark_clean(e)
                        # A successful write-back forgives earlier transient
                        # failures: the retry bound is per write-back
                        # episode, not per page lifetime.
                        e.wb_retries = 0
                        shard.counters["writebacks"] += 1
                        e.event.set()
                    if si == seed_si and len(run) > 1:
                        shard.counters["coalesced_writebacks"] += 1
                        shard.counters["writeback_pages"] += len(run)
                    shard.cond.notify_all()

    def _fail_writeback(self, run: List[PageEntry], exc: BaseException,
                        evicting: bool) -> None:
        """Handle a failed write-back run (DESIGN.md §14.4).

        Pages re-mark DIRTY (they never stopped being dirty — ``mark_clean``
        runs only after a successful write) and are re-posted to the
        cleaner queue for a bounded number of retries
        (``config.writeback_retries``); past the bound they are
        **quarantined**: resident + dirty, excluded from cleaning and
        eviction so their un-persisted bytes are never dropped, counted in
        ``quarantined_pages``, and ``flush_region`` raises on them.  Evict-
        path victims additionally re-enter their shard's eviction policy
        (their ``on_remove`` ran at selection).
        """
        limit = self.config.writeback_retries
        repost: List[PageEntry] = []
        for e in run:
            shard = self._shard_of(e.key)
            with self._locked(shard):
                shard.counters["writeback_errors"] += 1
                e.wb_retries += 1
                in_table = shard.table.get(e.key) is e
                if evicting and in_table:
                    shard.policy.on_install(e.key)   # re-track the victim
                if e.wb_retries < limit and in_table:
                    # Retry through the cleaner queue: back to CLEANING
                    # (bytes stay stable; no path pins CLEANING pages).
                    e.state = PageState.CLEANING
                    e.event.clear()
                    repost.append(e)
                else:
                    e.state = PageState.PRESENT
                    if in_table and not e.quarantined:
                        e.quarantined = True
                        shard.counters["quarantined_pages"] += 1
                    e.event.set()
                shard.cond.notify_all()
        for e in repost:
            self._clean_q.put(("clean", e))

    def _evict_now_batch(self, victims: List[PageEntry]) -> None:
        """Write back dirty victims (batched per adjacent run) and free all
        their slots.  No locks held on entry; victims are EVICTING, which no
        path can pin or re-dirty, so bytes are stable across the write.
        A run whose write fails keeps its pages RESIDENT (dirty data must
        not be dropped) — see :meth:`_fail_writeback`."""
        writable = []
        for v in victims:
            region = self._regions.get(v.key[0])
            if v.dirty and region is not None:
                writable.append((region, v))
        wrote = set()
        failed = set()
        for region, run in self._writeback_runs(writable):
            try:
                self._write_run(region, run)
            except Exception as exc:
                self._fail_writeback(run, exc, evicting=True)
                failed.update(e.key for e in run)
                continue
            seed_si = self._shard_index(run[0].key)
            if len(run) > 1:
                shard = self.shards[seed_si]
                with self._locked(shard):
                    shard.counters["coalesced_writebacks"] += 1
                    shard.counters["writeback_pages"] += len(run)
            wrote.update(e.key for e in run)
        for v in victims:
            if v.key in failed:
                continue               # reverted by _fail_writeback
            shard = self._shard_of(v.key)
            with self._locked(shard):
                if v.key in wrote:
                    shard.counters["writebacks"] += 1
                self.buffer.release(v.slot)
                shard.free.append(v.slot)
                shard.table.remove(v)
                shard.counters["evictions"] += 1
                shard.cond.notify_all()

    def submit_clean_batch(self, max_pages: int) -> int:
        """Queue up to ``max_pages`` dirty pages for write-back (watermarks)."""
        posted = 0
        for shard in self.shards:
            if posted >= max_pages:
                break
            with self._locked(shard):
                posted += self._post_shard_clean_locked(
                    shard, max_pages - posted)
        if posted:
            self._svc["watermark_flushes"] += 1
        return posted

    # -------------------------------------------------------------- flush

    def flush_region(self, region: "UMapRegion", evict: bool = False,
                     deadline: Optional[float] = None) -> None:
        """Synchronously write back all dirty pages of a region (§3.5).

        With ``evict=True`` also drops the pages (uunmap path).  Loops until
        no page of the region is dirty/resident (evict) and none is in
        flight — combined with the region's closing gate this guarantees no
        fill can re-install a page after an unregister flush returns.

        ``deadline`` (``time.monotonic()`` value, close path only) bounds
        the in-flight drain: a FILLING page whose store call is stalled
        would otherwise spin this loop forever.  Past the deadline the
        drain gives up on *in-flight* pages with a warning (dirty PRESENT
        pages were already batched out — no silent durability loss beyond
        what the stall itself implies).

        Quarantined pages (write-back retries exhausted, §14.4) cannot be
        persisted: they are skipped by the drain and reported by raising
        ``IOError`` once everything else has flushed — silently returning
        would let callers believe un-persisted bytes are durable.
        """
        while True:
            batch: List[PageEntry] = []
            pending = False
            for shard in self.shards:
                with self._locked(shard):
                    for e in shard.table.region_entries(region.region_id):
                        if e.quarantined:
                            continue         # reported after the drain
                        if (e.state is PageState.PRESENT
                                and (e.dirty or evict) and e.pins == 0):
                            e.state = (PageState.EVICTING if evict
                                       else PageState.CLEANING)
                            e.event.clear()
                            if evict:
                                shard.policy.on_remove(e.key)
                            batch.append(e)
                        elif (e.state in (PageState.FILLING, PageState.CLEANING,
                                          PageState.EVICTING) or e.pins > 0):
                            pending = True
            if not batch:
                if not pending:
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    warnings.warn(
                        f"flush of region {region.name or region.region_id} "
                        f"abandoned in-flight pages at the close deadline "
                        f"(stalled store I/O)", UserWarning, stacklevel=2)
                    break
                time.sleep(0.001)
                continue
            # Adjacent dirty pages drain as single write_from_batch calls —
            # the flush path shares the cleaner pipeline's coalescing.
            if evict:
                self._evict_now_batch(batch)
            else:
                self._do_clean_batch(batch)
        quarantined = [
            e.key[1] for shard in self.shards
            for e in shard.table.region_entries(region.region_id)
            if e.quarantined
        ]
        region.store.flush()
        if quarantined:
            raise IOError(
                f"flush of region {region.name or region.region_id} left "
                f"{len(quarantined)} quarantined dirty page(s) "
                f"(write-back retries exhausted): {sorted(quarantined)[:8]}")

    def retry_quarantined(self, region: Optional["UMapRegion"] = None) -> int:
        """Re-post quarantined pages to the cleaner queue with a fresh
        retry budget (DESIGN.md §17.4).

        Quarantined pages (write-back retries exhausted, §14.4) are stuck
        by design until the operator — or the store's own circuit breaker
        transitioning open → closed, which auto-invokes this — declares the
        store healthy again.  Each re-posted page gets the full
        ``config.writeback_retries`` budget; pages that fail again simply
        re-quarantine.  Restricted to ``region`` when given, else every
        registered region.  Returns the number of pages re-posted;
        ``quarantine_retries`` counts them cumulatively, and
        ``quarantined_pages`` — a gauge of *currently* quarantined pages —
        drops by one per re-post (a page that fails write-back again
        simply re-quarantines and bumps it back).
        """
        with self.lock:
            if region is not None:
                rids = [region.region_id]
            else:
                rids = list(self._regions)
        repost: List[PageEntry] = []
        for shard in self.shards:
            with self._locked(shard):
                for rid in rids:
                    for e in shard.table.region_entries(rid):
                        if not (e.quarantined and e.state is PageState.PRESENT
                                and e.pins == 0 and e.dirty):
                            continue
                        e.quarantined = False
                        e.wb_retries = 0
                        e.state = PageState.CLEANING
                        e.event.clear()
                        shard.counters["quarantine_retries"] += 1
                        shard.counters["quarantined_pages"] -= 1
                        repost.append(e)
        for e in repost:
            self._clean_q.put(("clean", e))
        return len(repost)

    # ------------------------------------------------------------- queries

    def open_breakers(self) -> int:
        """Number of OPEN circuit breakers across registered regions'
        stores — the serve engine's degraded-paging signal (DESIGN.md
        §17.9).  Lock-free scrape: breaker state is a GIL-atomic attribute
        read; a racing registration just defers to the next poll."""
        from .resilient import iter_breakers
        try:
            regions = list(self._regions.values())
        except RuntimeError:            # dict mutated mid-iteration
            return 0
        seen, n = set(), 0
        for r in regions:
            for br in iter_breakers(r.store):
                if id(br) not in seen:
                    seen.add(id(br))
                    n += br.state == "open"
        return n

    def dirty_ratio(self) -> float:
        return self.table.dirty_count / max(1, self.buffer.num_slots)

    def resident_pages(self, region_id: Optional[int] = None) -> int:
        total = 0
        for shard in self.shards:
            with self._locked(shard):
                if region_id is None:
                    total += len(shard.table.resident_keys())
                else:
                    total += sum(1 for (rid, _) in shard.table.resident_keys()
                                 if rid == region_id)
        return total
