"""Physical-page allocator for the device KV pool (host-managed free list).

A copy of ``repro/kvcache/allocator.py`` (pure Python + numpy), kept in the
port so that it imports nothing of the JAX package.

The device pool is the UMap buffer; this allocator is the slot free-list
(core/buffer.py) specialized for KV pages, plus per-sequence accounting so
the serving engine can evict whole sequences (uunmap analogue) or individual
cold pages (watermark analogue).

Since the multi-tenant serving engine (DESIGN.md §16) pages are
*refcounted*: a physical page may be mapped into several sequences' page
tables at once (prompt-prefix sharing — Nomad's non-exclusive residency
applied to KV pages).  A shared page is read-only by convention; the first
writer calls :meth:`make_private` (copy-on-write) to get its own physical
page, and the allocator only returns a page to the free list when its last
mapping is released.  Refcount invariants (property-tested in
tests/test_kv_property.py):

  * ``refcount(p)`` equals the number of sequence page-table entries that
    reference ``p`` — share() increments, free_seq/free_prefix/make_private
    decrement;
  * a page is either free or referenced, never both, and
    ``free_pages + referenced == num_pages``;
  * refcount 0 ⇒ the page is back on the free list exactly once.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class OutOfPages(RuntimeError):
    pass


class PageAllocator:
    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._refs: Dict[int, int] = {}             # page -> live mappings
        self._seq_pages: Dict[int, List[int]] = {}  # seq_id -> pages in order
        self.cow_copies = 0                         # make_private page copies
        self.shared_mapped = 0                      # pages mapped via share()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def occupancy(self) -> float:
        return self.used_pages / self.num_pages

    def alloc(self, seq_id: int, n: int = 1) -> List[int]:
        if len(self._free) < n:
            raise OutOfPages(
                f"need {n} pages, {len(self._free)} free of {self.num_pages}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self._seq_pages.setdefault(seq_id, []).extend(pages)
        return pages

    def pages_of(self, seq_id: int) -> List[int]:
        return list(self._seq_pages.get(seq_id, []))

    # ------------------------------------------------- copy-on-write sharing

    def refcount(self, page: int) -> int:
        """Live mappings of a physical page (0 = free)."""
        return self._refs.get(page, 0)

    def shared_pages(self) -> int:
        """Physical pages currently mapped by more than one sequence."""
        return sum(1 for n in self._refs.values() if n > 1)

    def share(self, src_seq: int, dst_seq: int, n_pages: int) -> List[int]:
        """Map the first ``n_pages`` of ``src_seq`` into ``dst_seq``.

        The pages become refcount-shared: both sequences' page tables point
        at the same physical pages (prompt-prefix sharing).  ``dst_seq``
        must not hold pages yet — a shared prefix is, by definition, the
        *front* of the destination's table.  Writers must
        :meth:`make_private` before mutating a shared page.
        """
        src = self._seq_pages.get(src_seq, [])
        if n_pages > len(src):
            raise ValueError(
                f"share of {n_pages} pages exceeds {src_seq}'s {len(src)}")
        if self._seq_pages.get(dst_seq):
            raise ValueError(
                f"sequence {dst_seq} already holds pages; a shared prefix "
                f"must be mapped before any private allocation")
        pages = src[:n_pages]
        for p in pages:
            self._refs[p] += 1
        if pages:
            self._seq_pages[dst_seq] = list(pages)
            self.shared_mapped += len(pages)
        return list(pages)

    def is_shared(self, seq_id: int, idx: int) -> bool:
        """True if the ``idx``-th page of ``seq_id`` has other mappings."""
        return self._refs[self._seq_pages[seq_id][idx]] > 1

    def make_private(self, seq_id: int, idx: int
                     ) -> Optional[Tuple[int, int]]:
        """Copy-on-write: give ``seq_id`` a private copy of its ``idx``-th
        page.  Returns ``(old_page, new_page)`` when a copy happened (the
        caller must copy the device contents old→new), or ``None`` when the
        page was already private.  Raises :class:`OutOfPages` when no free
        page is available for the copy."""
        pages = self._seq_pages[seq_id]
        old = pages[idx]
        if self._refs[old] == 1:
            return None
        if not self._free:
            raise OutOfPages("copy-on-write needs a free page, none left")
        new = self._free.pop()
        self._refs[new] = 1
        self._refs[old] -= 1
        pages[idx] = new
        self.cow_copies += 1
        return old, new

    def _decref(self, page: int) -> None:
        n = self._refs[page] - 1
        if n:
            self._refs[page] = n
        else:
            del self._refs[page]
            self._free.append(page)

    # ---------------------------------------------------------------- free

    def free_seq(self, seq_id: int) -> int:
        """Release all of a sequence's mappings.  Shared pages survive until
        their last referencing sequence releases them."""
        pages = self._seq_pages.pop(seq_id, [])
        for p in pages:
            self._decref(p)
        return len(pages)

    def free_prefix(self, seq_id: int, n: int) -> List[int]:
        """Release the oldest n pages of a sequence (sliding-window evict)."""
        pages = self._seq_pages.get(seq_id, [])
        drop, keep = pages[:n], pages[n:]
        self._seq_pages[seq_id] = keep
        for p in drop:
            self._decref(p)
        return drop

    def table_for(self, seq_id: int, max_pages: int,
                  fill: int = 0) -> np.ndarray:
        """Fixed-width page table row (padded with ``fill``)."""
        pages = self._seq_pages.get(seq_id, [])
        row = np.full(max_pages, fill, np.int32)
        row[: len(pages)] = pages[:max_pages]
        return row
