"""Zero-copy page leases (DESIGN.md §13).

A *lease* is a pinned view directly into a :class:`PageBuffer` slot: the
application reads (or, with ``write=True``, mutates) page bytes in place,
with no staging memcpy on either side.  The pin rides the existing
``entry.pins`` refcount, so a leased page is ineligible for eviction and
for cleaner write-back for exactly as long as the view is live — the lease
is the ownership token that makes handing buffer internals to the
application safe.

Life-cycle::

    with region.lease(page_no, write=True) as ls:
        ls.view[...] = ...          # in-place, no copy
    # release: page marked dirty exactly once, pin dropped, evictors notified

``region.lease_run(first_page, npages)`` leases an adjacent run (posting
all fills up front for I/O overlap).  Runs hold several pins on one thread
— the one place the pager's one-pin-per-thread deadlock-freedom argument is
traded away — so the service caps run length (``config.max_lease_run``,
further clamped to half the buffer).

With ``config.zero_copy_leases=False`` every lease is *copy-backed*: the
view is a private snapshot and a write-lease writes it back through
``region.write`` on release.  Same API, no aliasing — the debugging mode
for isolating lease/eviction interactions.

Locking: lease grant and release each take the page's stripe lock once
(the same order-3 locks as every metadata mutation, DESIGN.md §12); no
lease code path ever holds two locks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from .pagetable import PageEntry
    from .region import UMapRegion


class PageLease:
    """One leased page: a pinned, zero-copy view into the page buffer.

    ``view`` is an ndarray aliasing the page's buffer slot (read-only for
    read leases).  Copy-backed leases (``entry is None``) own a private
    snapshot instead.  ``release()`` is idempotent; a write-lease marks the
    page dirty exactly once, on the first release.
    """

    __slots__ = ("region", "page_no", "write", "view", "exclusive",
                 "_entry", "_released")

    def __init__(self, region: "UMapRegion", page_no: int, write: bool,
                 view: np.ndarray, entry: Optional["PageEntry"],
                 exclusive: bool = False):
        self.region = region
        self.page_no = page_no
        self.write = write
        self.view = view
        # Snapshot read lease (exclude_writers=True at grant): holds the
        # page's `excl_reads` exclusion count until release (§18.4).
        self.exclusive = exclusive
        self._entry = entry          # None => copy-backed
        self._released = False

    @property
    def zero_copy(self) -> bool:
        return self._entry is not None

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        if self._entry is not None:
            self.region.service.release_lease(self._entry, self.write,
                                              excl=self.exclusive)
        elif self.write:
            # Copy-backed write lease: publish the snapshot through the
            # normal dirty-tracking write path.
            self.region.write(self.page_no * self.region.page_size, self.view)

    def abandon(self) -> None:
        """Release WITHOUT the write-lease dirty mark.

        Only correct while the view has never been handed to the
        application — ``lease_run`` uses it on abort-and-retry and on
        grant-path errors, where marking untouched pages dirty would
        generate spurious write-back traffic.
        """
        if self._released:
            return
        self._released = True
        if self._entry is not None:
            # Pass the TRUE grant flags so the exclusion counters unwind;
            # dirty=False suppresses only the write-back side effect.
            self.region.service.release_lease(self._entry, self.write,
                                              excl=self.exclusive,
                                              dirty=False)

    def __enter__(self) -> "PageLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover
        mode = "rw" if self.write else "ro"
        kind = "zero-copy" if self.zero_copy else "copy-backed"
        return (f"PageLease(page={self.page_no}, {mode}, {kind}, "
                f"released={self._released})")


class LeaseRun:
    """An adjacent run of page leases, released as one unit."""

    __slots__ = ("leases",)

    def __init__(self, leases: Sequence[PageLease]):
        self.leases: List[PageLease] = list(leases)

    @property
    def views(self) -> List[np.ndarray]:
        return [ls.view for ls in self.leases]

    def __len__(self) -> int:
        return len(self.leases)

    def __iter__(self):
        return iter(self.leases)

    def __getitem__(self, i: int) -> PageLease:
        return self.leases[i]

    def release(self) -> None:
        for ls in self.leases:
            ls.release()

    def __enter__(self) -> "LeaseRun":
        return self

    def __exit__(self, *exc) -> None:
        self.release()
