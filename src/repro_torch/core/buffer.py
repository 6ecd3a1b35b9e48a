"""Page buffer — the fixed pool of physical page slots (paper §3.1, §3.6).

The buffer is the UMap analogue of the kernel page cache: ``num_slots`` slots
of ``slot_size`` bytes each, allocated once up front (``UMAP_BUFSIZE``).
Capacity pressure triggers the eviction policy; dirty pressure triggers the
watermark flusher (see watermark.py).

Eviction policies are pluggable (paper §3.6 "a user-defined strategy"):

  fifo   evict in install order
  lru    evict least-recently-touched (kernel default; paper §2.1)
  clock  second-chance approximation of LRU (one ref bit per page)
  swa    sliding-window: evict the lowest page number first — the natural
         policy for sliding-window attention KV pages and for strictly
         forward-moving streams (lrzip).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Iterable, List, Optional

import numpy as np

from .pagetable import PageKey


class EvictionPolicy:
    """Tracks residency order; picks victims among eligible resident pages."""

    name = "base"

    def on_install(self, key: PageKey) -> None:
        raise NotImplementedError

    def on_touch(self, key: PageKey) -> None:
        pass

    def on_remove(self, key: PageKey) -> None:
        raise NotImplementedError

    def pick_victims(self, n: int, eligible: Callable[[PageKey], bool]) -> List[PageKey]:
        raise NotImplementedError

    def adopt(self, keys: Iterable[PageKey]) -> None:
        """Seed a fresh policy with already-resident pages.

        Used by :meth:`PagingService.set_eviction_policy` to swap policies at
        runtime (the adaptive engine retuning eviction mid-run, DESIGN.md §8)
        without losing track of what is resident.  Recency/ref-bit history is
        deliberately not carried over: the swap happens precisely because the
        access pattern changed, so the old ordering is stale evidence.
        """
        for k in keys:
            self.on_install(k)


class FifoPolicy(EvictionPolicy):
    name = "fifo"

    def __init__(self):
        self._order: "OrderedDict[PageKey, None]" = OrderedDict()

    def on_install(self, key):
        self._order[key] = None

    def on_remove(self, key):
        self._order.pop(key, None)

    def pick_victims(self, n, eligible):
        out = []
        for key in self._order:
            if eligible(key):
                out.append(key)
                if len(out) == n:
                    break
        return out


class LruPolicy(FifoPolicy):
    name = "lru"

    def on_touch(self, key):
        if key in self._order:
            self._order.move_to_end(key)


class ClockPolicy(EvictionPolicy):
    name = "clock"

    def __init__(self):
        self._order: "OrderedDict[PageKey, bool]" = OrderedDict()  # key -> ref bit

    def on_install(self, key):
        self._order[key] = True

    def on_touch(self, key):
        if key in self._order:
            self._order[key] = True

    def on_remove(self, key):
        self._order.pop(key, None)

    def pick_victims(self, n, eligible):
        out: List[PageKey] = []
        # Up to two sweeps: first clears ref bits, second takes victims.
        for _ in range(2):
            for key in list(self._order.keys()):
                if len(out) == n:
                    return out
                if not eligible(key) or key in out:
                    continue
                if self._order.get(key, False):
                    self._order[key] = False  # second chance
                else:
                    out.append(key)
            if out:
                break
        # Desperation: take any eligible page.
        if len(out) < n:
            for key in self._order:
                if eligible(key) and key not in out:
                    out.append(key)
                    if len(out) == n:
                        break
        return out


class SlidingWindowPolicy(EvictionPolicy):
    """Evict lowest (region, page_no) first — forward-moving streams."""

    name = "swa"

    def __init__(self):
        self._keys: set = set()

    def on_install(self, key):
        self._keys.add(key)

    def on_remove(self, key):
        self._keys.discard(key)

    def pick_victims(self, n, eligible):
        out = []
        for key in sorted(self._keys):
            if eligible(key):
                out.append(key)
                if len(out) == n:
                    break
        return out


POLICIES = {p.name: p for p in (FifoPolicy, LruPolicy, ClockPolicy, SlidingWindowPolicy)}


def make_policy(name: str) -> EvictionPolicy:
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(f"unknown eviction policy {name!r}; choose from {sorted(POLICIES)}")


# ---------------------------------------------------------------------------


class PageBuffer:
    """``num_slots`` × ``slot_size`` bytes of pinned 'physical' memory.

    The buffer owns only the memory and the slot→page ownership record.
    *Free-list management lives in the paging service's shards* (DESIGN.md
    §12): :meth:`partition` hands each shard a disjoint slot set, and shards
    claim/release slots under their own locks, so slot allocation on
    different shards never contends.  ``claim``/``release`` are single
    GIL-atomic list-item writes; the occupancy queries below are lock-free
    scans that may be momentarily stale while workers run — exact when the
    service is quiescent, which is when tests and telemetry read them.
    """

    def __init__(self, num_slots: int, slot_size: int):
        if num_slots < 1:
            raise ValueError("buffer needs at least one slot")
        self.num_slots = num_slots
        self.slot_size = slot_size
        self._mem = np.zeros((num_slots, slot_size), dtype=np.uint8)
        self._owner: List[Optional[PageKey]] = [None] * num_slots

    def partition(self, nshards: int) -> List[List[int]]:
        """Disjoint round-robin slot sets, one per shard.

        Striped (slot ``s`` goes to shard ``s % nshards``) so truncated
        buffers spread evenly; every shard is non-empty when
        ``nshards <= num_slots`` (the service clamps to guarantee it).
        """
        parts: List[List[int]] = [[] for _ in range(nshards)]
        for s in range(self.num_slots - 1, -1, -1):
            parts[s % nshards].append(s)
        return parts

    @property
    def free_slots(self) -> int:
        return self.num_slots - self.used_slots

    @property
    def used_slots(self) -> int:
        return sum(1 for o in self._owner if o is not None)

    def occupancy(self) -> float:
        return self.used_slots / self.num_slots

    def claim(self, slot: int, key: PageKey) -> None:
        """Record ``key`` as the owner of ``slot`` (caller holds shard lock)."""
        assert self._owner[slot] is None, f"slot {slot} already owned"
        self._owner[slot] = key

    def release(self, slot: int) -> None:
        assert self._owner[slot] is not None, f"double free of slot {slot}"
        self._owner[slot] = None

    def slot_view(self, slot: int, nbytes: Optional[int] = None) -> np.ndarray:
        v = self._mem[slot]
        return v if nbytes is None else v[:nbytes]

    def owner(self, slot: int) -> Optional[PageKey]:
        return self._owner[slot]
