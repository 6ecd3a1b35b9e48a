"""UMap regions — the mmap-like application API (paper §4.1).

    service = PagingService(UMapConfig(page_size=512 * 1024, ...))
    region  = umap(store, service=service)          # register a region
    data    = region.read(offset, nbytes)           # demand paging
    region.write(offset, payload)                   # dirty tracking
    region.prefetch_pages([17, 3, 900])             # arbitrary-set prefetch
    arr     = region.view(np.int64)                 # array-style access
    uunmap(region)                                  # flush + unregister

Regions attach to a shared :class:`PagingService` (one buffer + worker pools
serving all regions, §3.3) or construct a private one from a config.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence, TYPE_CHECKING

import numpy as np

from .config import UMapConfig
from .lease import LeaseRun, PageLease
from .pager import PagingService
from .store import BackingStore, TierChain

if TYPE_CHECKING:  # pragma: no cover
    from .hints import AccessAdvice, TierHint


class UMapRegion:
    def __init__(
        self,
        store: BackingStore,
        service: PagingService,
        page_size: Optional[int] = None,
        readahead_pages: Optional[int] = None,
        fill_callback: Optional[Callable] = None,
        name: str = "",
    ):
        cfg = service.config
        if cfg.resilient_io:
            # Resilience composition (DESIGN.md §17.5): tiered stores wrap
            # per level (one breaker each — a tripped tier must not gate
            # the others), everything else wraps whole.  Done before the
            # tiered check below, which wrap_store preserves (TierChain
            # identity is kept; only its levels are replaced in place).
            from .resilient import wrap_store
            store = wrap_store(store, cfg)
        self.store = store
        self.service = service
        self.page_size = int(page_size or cfg.page_size)
        if self.page_size > service.buffer.slot_size:
            raise ValueError(
                f"region page size {self.page_size} exceeds buffer slot size "
                f"{service.buffer.slot_size}"
            )
        self.readahead_pages = cfg.read_ahead if readahead_pages is None else readahead_pages
        self.fill_callback = fill_callback or cfg.fill_callback
        self.name = name
        self.num_pages = -(-store.size // self.page_size)
        # Static-hint precedence (DESIGN.md §8): an explicit readahead_pages
        # argument pins this region — the adaptive classifier never retunes
        # pinned regions.  advise() pins at runtime.  Must be set before
        # register(), which decides whether to attach a classifier.
        self.hint_pinned = readahead_pages is not None
        self.advice: Optional["AccessAdvice"] = None
        self.detected_stride = 1   # classifier-detected fault stride
        # Tiered-store regions feed the pager's heat counters and the
        # migration engine (DESIGN.md §14); must be set before register(),
        # which starts the migration thread on the first tiered region.
        self.tiered = isinstance(store, TierChain)
        # Closing gate (DESIGN.md §12): set by unregister() *before* the
        # evicting flush.  New faults raise, queued fills are abandoned, so
        # no fill can re-install a page after the region is dropped.
        self._closing = False
        self.region_id = service.register(self)
        self._closed = False
        # mmap-compat heuristic readahead state (sequential-streak detector)
        self._ra_lock = threading.Lock()
        self._ra_last_page = -2
        self._ra_streak = 0

    # ------------------------------------------------------------------ geometry

    @property
    def size(self) -> int:
        return self.store.size

    def page_nbytes(self, page_no: int) -> int:
        """Bytes of page ``page_no`` (the final page may be short)."""
        start = page_no * self.page_size
        return min(self.page_size, self.store.size - start)

    def _page_range(self, offset: int, nbytes: int) -> List[int]:
        if not (0 <= offset and offset + nbytes <= self.size):
            raise IndexError(
                f"range [{offset}, {offset + nbytes}) outside region of {self.size} bytes"
            )
        first = offset // self.page_size
        last = (offset + nbytes - 1) // self.page_size if nbytes else first
        return list(range(first, last + 1))

    # ------------------------------------------------------------------ I/O

    def read(self, offset: int, nbytes: int) -> np.ndarray:
        """Read bytes through the page buffer (faulting as needed)."""
        out = np.empty(nbytes, dtype=np.uint8)
        if nbytes == 0:
            return out
        pages = self._page_range(offset, nbytes)
        self._mmap_heuristic_readahead(pages)
        # Post all fills up front (I/O overlap), then copy one page at a
        # time.  The fast path copies under the page's stripe lock (one
        # acquisition); only pages still in flight fall back to the pinning
        # fault path (deadlock-freedom: at most one pin per thread).
        self.service.request_fills(self, pages)
        pos = 0
        for pno in pages:
            page_lo = pno * self.page_size
            lo = max(offset, page_lo)
            hi = min(offset + nbytes, page_lo + self.page_nbytes(pno))
            dst = out[pos : pos + (hi - lo)]
            if not self.service.copy_page_out(self, pno, lo - page_lo, dst):
                e = self.service.acquire_one(self, pno)
                try:
                    slot = self.service.buffer.slot_view(
                        e.slot, self.service.buffer.slot_size)
                    dst[:] = slot[lo - page_lo : hi - page_lo]
                finally:
                    self.service.release_one(e)
            pos += hi - lo
        return out

    def write(self, offset: int, data: np.ndarray | bytes) -> None:
        """Write bytes through the page buffer; pages become dirty (§3.5)."""
        src = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) \
            else data.reshape(-1).view(np.uint8)
        if src.nbytes == 0:
            return
        pages = self._page_range(offset, src.nbytes)
        self.service.request_fills(self, pages)
        pos = 0
        for pno in pages:
            page_lo = pno * self.page_size
            lo = max(offset, page_lo)
            hi = min(offset + src.nbytes, page_lo + self.page_nbytes(pno))
            chunk = src[pos : pos + (hi - lo)]
            if self.service.copy_page_in(self, pno, lo - page_lo, chunk):
                self.service.watermark.poke()
            else:
                e = self.service.acquire_one(self, pno)
                try:
                    slot = self.service.buffer.slot_view(
                        e.slot, self.service.buffer.slot_size)
                    slot[lo - page_lo : hi - page_lo] = chunk
                    self.service.mark_dirty_one(e)
                finally:
                    self.service.release_one(e)
            pos += hi - lo

    # ------------------------------------------------- zero-copy leases (§13)

    def lease(self, page_no: int, write: bool = False,
              exclude_writers: bool = False) -> PageLease:
        """Lease page ``page_no``: a pinned view straight into the page
        buffer — no memcpy (DESIGN.md §13).

            with region.lease(7, write=True) as ls:
                ls.view[:8] = payload          # in-place mutation

        The page is ineligible for eviction/write-back while the lease is
        live; a write-lease marks it dirty exactly once, on release.
        ``exclude_writers=True`` (read leases only) grants a *snapshot*
        lease that blocks until live write leases on the page release, and
        excludes new write leases until it is released (§18.4) — used by
        consistent-snapshot readers such as the async checkpointer.  For
        small sub-page transfers ``read``/``write`` (the locked-copy fast
        path) remain cheaper than lease bookkeeping — leases pay off for
        whole-page and multi-page access.
        """
        if not 0 <= page_no < self.num_pages:
            raise IndexError(
                f"page {page_no} outside region of {self.num_pages} pages")
        return self.service.lease_page(self, page_no, write=write,
                                       exclude_writers=exclude_writers)

    def lease_run(self, first_page: int, npages: int,
                  write: bool = False,
                  exclude_writers: bool = False) -> LeaseRun:
        """Lease ``npages`` adjacent pages as one unit (fills posted up
        front for I/O overlap).  Length-capped — see
        :meth:`PagingService.lease_run`."""
        if not (0 <= first_page and first_page + npages <= self.num_pages):
            raise IndexError(
                f"run [{first_page}, {first_page + npages}) outside region "
                f"of {self.num_pages} pages")
        return self.service.lease_run(self, first_page, npages, write=write,
                                      exclude_writers=exclude_writers)

    # ------------------------------------------------------------- hints

    def advise(self, advice: Optional["AccessAdvice"] = None,
               tier_hint: "TierHint | str | None" = None,
               offset: int = 0, nbytes: Optional[int] = None) -> None:
        """Declare this region's access pattern (madvise analogue, §3.6).

        With ``advice`` set, applies the advice's readahead immediately,
        swaps the service's eviction policy (service-wide — regions sharing
        a service share a buffer and hence a policy, §3.3), and *pins* the
        region: the online classifier will never override an explicit hint
        (DESIGN.md §8).

        With ``tier_hint`` set (``"hot"`` / ``"cold"`` / ``"pin_fast"``, a
        tiered-store region only), overrides the migration engine's heat
        for the byte range ``[offset, offset + nbytes)`` (default: the
        whole region) — the paper's application-hints design extended to
        tier placement (DESIGN.md §14.3).  On an N-level chain, HOT and
        PIN_FAST accept a target cache level suffix (``"hot:1"``,
        ``"pin_fast:2"``); the bare forms target level 0.  The two hint
        kinds compose and may be passed together.
        """
        if advice is None and tier_hint is None:
            raise ValueError("advise() needs an access advice, a tier "
                             "hint, or both")
        if advice is not None:
            from .hints import ADVICE_SETTINGS  # local: hints imports config
            settings = ADVICE_SETTINGS[advice]
            with self.service.lock:   # exclude in-flight classifier decision
                self.advice = advice
                self.hint_pinned = True
                self.readahead_pages = settings["read_ahead"]
                self.detected_stride = 1
            self.service.set_eviction_policy(settings["eviction_policy"])
        if tier_hint is not None:
            self.advise_tier(tier_hint, offset=offset, nbytes=nbytes)

    def advise_tier(self, hint: "TierHint | str", offset: int = 0,
                    nbytes: Optional[int] = None) -> None:
        """Tier-placement hint for a byte range (DESIGN.md §14.3)."""
        from .hints import parse_tier_hint  # local: hints imports config
        if not self.tiered:
            raise ValueError(
                "tier hints require a TierChain-backed region")
        hint, level = parse_tier_hint(hint)
        if level is not None and level >= self.store.base_level:
            raise ValueError(
                f"tier hint level {level} out of range: chain has cache "
                f"levels 0..{self.store.base_level - 1}")
        nbytes = self.size - offset if nbytes is None else nbytes
        if nbytes <= 0 or offset < 0 or offset + nbytes > self.size:
            raise IndexError(
                f"tier-hint range [{offset}, {offset + nbytes}) outside "
                f"region of {self.size} bytes")
        es = self.store.extent_size
        extents = list(range(offset // es, (offset + nbytes - 1) // es + 1))
        self.service.apply_tier_hint(self, hint, extents,
                                     level=0 if level is None else level)

    def prefetch(self, offset: int, nbytes: int) -> int:
        return self.prefetch_pages(self._page_range(offset, nbytes))

    def prefetch_pages(self, page_nos: Sequence[int]) -> int:
        """Prefetch an arbitrary page set (paper §3.6)."""
        return self.service.prefetch(self, [p for p in page_nos if 0 <= p < self.num_pages])

    def _mmap_heuristic_readahead(self, pages: List[int]) -> None:
        """Kernel-style seq/random readahead for the mmap baseline (§2.1)."""
        if not self.service.config.mmap_compat:
            return
        with self._ra_lock:
            first = pages[0]
            if first in (self._ra_last_page, self._ra_last_page + 1):
                self._ra_streak = min(self._ra_streak + 1, 5)
            else:
                self._ra_streak = 0
            self._ra_last_page = pages[-1]
            window = (1 << self._ra_streak) if self._ra_streak else 0  # up to 32 pages
        if window:
            last = pages[-1]
            self.service.prefetch(
                self, list(range(last + 1, min(last + 1 + window, self.num_pages)))
            )

    # ------------------------------------------------------------- views

    def view(self, dtype=np.uint8, shape: Optional[tuple] = None) -> "UMapArrayView":
        return UMapArrayView(self, np.dtype(dtype), shape)

    # ------------------------------------------------------------- control

    def flush(self) -> None:
        self.service.flush_region(self, evict=False)

    def stats(self) -> dict:
        return self.service.stats.snapshot()

    def close(self) -> None:
        if not self._closed:
            # Mark closed BEFORE the unregister flush: a quarantine IOError
            # (DESIGN.md §14.4) propagates to the caller, but the region is
            # unregistered either way and a second close must not re-flush.
            self._closed = True
            self.service.unregister(self)


class UMapArrayView:
    """numpy-flavored element access over a region (convenience layer)."""

    def __init__(self, region: UMapRegion, dtype: np.dtype, shape: Optional[tuple]):
        self.region = region
        self.dtype = dtype
        n_items = region.size // dtype.itemsize
        self.shape = shape if shape is not None else (n_items,)
        if int(np.prod(self.shape)) * dtype.itemsize > region.size:
            raise ValueError("view shape exceeds region size")
        self._strides = np.array(
            [int(np.prod(self.shape[i + 1 :])) for i in range(len(self.shape))], np.int64
        )

    def __len__(self) -> int:
        return self.shape[0]

    def _flat_range(self, idx):
        """Resolve an index/slice on axis 0 to a flat element range."""
        if isinstance(idx, slice):
            start, stop, step = idx.indices(self.shape[0])
            if step != 1:
                raise IndexError("only unit-stride slices are supported")
        else:
            start, stop = int(idx), int(idx) + 1
            if not 0 <= start < self.shape[0]:
                raise IndexError(idx)
        row = int(self._strides[0])
        return start * row, stop * row, (stop - start,) + tuple(self.shape[1:])

    def __getitem__(self, idx):
        lo, hi, shape = self._flat_range(idx)
        raw = self.region.read(lo * self.dtype.itemsize, (hi - lo) * self.dtype.itemsize)
        out = raw.view(self.dtype).reshape(shape)
        return out[0] if not isinstance(idx, slice) else out

    def __setitem__(self, idx, value) -> None:
        lo, hi, shape = self._flat_range(idx)
        arr = np.ascontiguousarray(np.broadcast_to(np.asarray(value, self.dtype), shape))
        self.region.write(lo * self.dtype.itemsize, arr)


# ---------------------------------------------------------------------------


def umap(
    store: BackingStore,
    config: Optional[UMapConfig] = None,
    service: Optional[PagingService] = None,
    **region_kw,
) -> UMapRegion:
    """Register a UMap region over ``store`` (paper §4.1 ``umap()``).

    Exactly one of ``config`` (spawns a private service) or ``service``
    (shared buffer across regions, §3.3) should be given; defaults to a
    private service built from environment variables.
    """
    if service is None:
        service = PagingService(config or UMapConfig.from_env())
        region = UMapRegion(store, service, **region_kw)
        region._owns_service = True
        return region
    if config is not None:
        raise ValueError("pass either config or service, not both")
    region = UMapRegion(store, service, **region_kw)
    region._owns_service = False
    return region


def uunmap(region: UMapRegion) -> None:
    """Flush, drop, and unregister a region (paper §4.1 ``uunmap()``).

    A quarantine ``IOError`` (un-persistable dirty pages, DESIGN.md §14.4)
    propagates to the caller, but an owned service still shuts down — its
    worker threads must not outlive the region.
    """
    service = region.service
    try:
        region.close()
    finally:
        if getattr(region, "_owns_service", False):
            service.close()
