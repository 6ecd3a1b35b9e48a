"""User-space page table (paper §3.1/§3.3).

One :class:`PageTable` instance serves *all* regions attached to a paging
service (the paper's "single UMap buffer object [that manages] the metadata of
in-memory pages for all regions").  Keys are ``(region_id, page_no)``.

Page life-cycle::

    ABSENT --fault--> FILLING --install--> PRESENT --victim--> EVICTING --> ABSENT
                                              |  ^
                                   (dirty) CLEANING  (write-back, stays resident)

The table itself is not thread-safe; the owning service serializes metadata
mutations under a lock and performs I/O outside it.  Since the sharded
refactor (DESIGN.md §12) a service holds one :class:`PageTable` *per shard*,
each guarded by that shard's lock; :class:`ShardedPageTableView` is the
read-mostly aggregate exposed as ``service.table`` for telemetry and tests.
"""

from __future__ import annotations

import enum
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PageKey = Tuple[int, int]  # (region_id, page_no)


class PageState(enum.Enum):
    FILLING = "filling"
    PRESENT = "present"
    CLEANING = "cleaning"   # dirty write-back in flight; remains resident
    EVICTING = "evicting"


class PageEntry:
    __slots__ = (
        "key", "state", "slot", "dirty", "pins", "leases", "event",
        "prefetched", "touched_after_prefetch", "error", "wb_retries",
        "quarantined", "write_leases", "excl_reads",
    )

    def __init__(self, key: PageKey, state: PageState, slot: int = -1):
        self.key = key
        self.state = state
        self.slot = slot
        self.dirty = False
        self.pins = 0
        # Error-propagation contract (DESIGN.md §14.4): a fill that died on
        # a store exception stashes it here *before* setting the event, so
        # every thread blocked at the fault site raises IOError instead of
        # re-faulting forever.
        self.error: Optional[BaseException] = None
        # Write-back failure accounting: bounded retries, then quarantine
        # (the page stays resident + dirty and is excluded from cleaning/
        # eviction so its un-persisted bytes are never dropped).
        self.wb_retries = 0
        self.quarantined = False
        # How many of `pins` are zero-copy leases (core/lease.py).  A leased
        # page is pinned like any other, but the distinction feeds the
        # `lease_blocked_evictions` telemetry: capacity/clean pressure that
        # cannot make progress because the application holds views.
        self.leases = 0
        # Writer-exclusion accounting (DESIGN.md §18.4): `write_leases`
        # counts the subset of `leases` granted with write=True, and
        # `excl_reads` the read leases granted with exclude_writers=True
        # (consistent-snapshot readers, e.g. the async checkpointer).  A
        # snapshot read lease blocks while write_leases > 0 and vice versa,
        # so a snapshot never aliases bytes mid-mutation.  Plain leases
        # ignore both counters — the historical no-exclusion behavior.
        self.write_leases = 0
        self.excl_reads = 0
        # Signaled when the page becomes PRESENT (UFFDIO_COPY semantics: wake
        # waiters only after the full page is installed) or when CLEANING /
        # EVICTING completes.
        self.event = threading.Event()
        self.prefetched = False           # filled by readahead, not demand
        self.touched_after_prefetch = False

    def __repr__(self):  # pragma: no cover
        return (f"PageEntry({self.key}, {self.state.value}, slot={self.slot}, "
                f"dirty={self.dirty}, pins={self.pins})")


class PageTable:
    def __init__(self):
        self._entries: Dict[PageKey, PageEntry] = {}
        self.dirty_count = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: PageKey) -> Optional[PageEntry]:
        return self._entries.get(key)

    def insert_filling(self, key: PageKey) -> PageEntry:
        assert key not in self._entries, f"duplicate page-table entry {key}"
        e = PageEntry(key, PageState.FILLING)
        self._entries[key] = e
        return e

    def install(self, entry: PageEntry, slot: int) -> None:
        """FILLING -> PRESENT with physical slot; wakes all fault waiters."""
        assert entry.state is PageState.FILLING
        entry.slot = slot
        entry.state = PageState.PRESENT
        entry.event.set()

    def mark_dirty(self, entry: PageEntry) -> None:
        if not entry.dirty:
            entry.dirty = True
            self.dirty_count += 1

    def mark_clean(self, entry: PageEntry) -> None:
        if entry.dirty:
            entry.dirty = False
            self.dirty_count -= 1

    def remove(self, entry: PageEntry) -> None:
        self.mark_clean(entry)
        del self._entries[entry.key]
        entry.event.set()

    # list(dict.items()) snapshots atomically under the GIL, so these stay
    # safe even when an aggregate view reads a table owned by another shard.

    def resident_keys(self):
        return [k for k, e in list(self._entries.items())
                if e.state is PageState.PRESENT]

    def evictable(self, entry: PageEntry) -> bool:
        return entry.state is PageState.PRESENT and entry.pins == 0

    def region_entries(self, region_id: int):
        return [e for k, e in list(self._entries.items()) if k[0] == region_id]


class ShardedPageTableView:
    """Aggregate read view over per-shard page tables (``service.table``).

    Mutation always goes through the owning shard under that shard's lock;
    this view is for telemetry, tests, and the watermark monitor.  Reads are
    lock-free — per-table counters are GIL-consistent ints and iteration
    snapshots each table — so values may be momentarily stale across shards
    but are exact whenever the service is quiescent.
    """

    def __init__(self, tables: Sequence[PageTable],
                 shard_index: Callable[[PageKey], int]):
        self._tables: List[PageTable] = list(tables)
        self._shard_index = shard_index

    def __len__(self) -> int:
        return sum(len(t) for t in self._tables)

    @property
    def dirty_count(self) -> int:
        return sum(t.dirty_count for t in self._tables)

    def get(self, key: PageKey) -> Optional[PageEntry]:
        return self._tables[self._shard_index(key)].get(key)

    def resident_keys(self) -> List[PageKey]:
        out: List[PageKey] = []
        for t in self._tables:
            out.extend(t.resident_keys())
        return out

    def region_entries(self, region_id: int) -> List[PageEntry]:
        out: List[PageEntry] = []
        for t in self._tables:
            out.extend(t.region_entries(region_id))
        return out
