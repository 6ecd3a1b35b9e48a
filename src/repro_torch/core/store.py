"""Backing-store abstraction (paper §3.4 — "Extensible Back Store").

A :class:`BackingStore` presents a flat byte space plus page-granular
``read_into`` / ``write_from`` access functions.  UMap regions attach one
store; fillers/evictors call only this interface, so new storage tiers (local
SSD, Lustre, memory server, FITS multi-file sets) are added by defining a new
store object — exactly the paper's extensibility argument.

Provided stores:

  FileStore        a single file on disk, accessed with positioned I/O
                   (os.pread/os.pwrite — releases the GIL, so filler threads
                   genuinely overlap I/O).
  MultiFileStore   several (file, offset, length) extents mapped into one
                   contiguous space (paper §4.1 "multi-file backed region";
                   the asteroid-detection FITS cube uses this).
  HostArrayStore   an in-memory numpy buffer (the "memory server" case and
                   the unit-test store).
  RemoteStore      wraps another store and models link latency + bandwidth
                   (network-interconnected HDD / Lustre in the paper's Intel
                   testbed).
  SyntheticStore   procedurally generated contents (no disk footprint) for
                   very large logical spaces.
  TierChain        composes an ordered list of stores (pmem → NVMe →
                   Lustre → ...) as a multi-level extent cache over the
                   last (base) store: per-level byte budgets, read-through
                   / write-back semantics, non-exclusive shadow copies, a
                   transactional promote/demote protocol driven by the
                   pager's utility-based migration engine, and online
                   per-level latency sampling (DESIGN.md §14).
  TieredStore      the original two-tier API, now a depth-2 facade over
                   TierChain (``fast``/``slow`` alias levels 0 and 1).
  FaultyStore      fault-injection wrapper: fails reads/writes after a
                   configurable number of operations — the regression
                   harness for the end-to-end I/O error propagation
                   contract (DESIGN.md §14.4).
"""

from __future__ import annotations

import abc
import os
import threading
import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np


def _slice_bufs(bufs: Sequence[np.ndarray], start: int, length: int) -> List[np.ndarray]:
    """Slices of the logical concatenation of ``bufs`` covering
    ``[start, start + length)`` — the scatter list for a sub-range of a
    batched read."""
    out: List[np.ndarray] = []
    pos = 0
    end = start + length
    for b in bufs:
        nb = b.nbytes
        lo, hi = max(start, pos), min(end, pos + nb)
        if lo < hi:
            mv = b.view(np.uint8)
            out.append(mv[lo - pos : hi - pos])
        pos += nb
        if pos >= end:
            break
    return out


class BackingStore(abc.ABC):
    """Flat byte space with positioned read/write."""

    #: Upper bound on how many adjacent pages a coalesced fill is worth
    #: batching for this store (per-store default; the pager caps batches at
    #: ``min(config.max_batch_pages, store.batch_read_hint)``).  High-latency
    #: stores want deep batches (one latency charge amortized over the run);
    #: in-memory stores gain little beyond queue/wakeup amortization.
    batch_read_hint: int = 8

    #: Same bound for the write side: the cleaner pipeline caps write-back
    #: runs at ``min(config.max_writeback_batch, store.batch_write_hint)``.
    batch_write_hint: int = 8

    @property
    @abc.abstractmethod
    def size(self) -> int:
        """Total logical size in bytes."""

    @abc.abstractmethod
    def read_into(self, offset: int, buf: np.ndarray) -> int:
        """Read ``len(buf)`` bytes at ``offset`` into ``buf`` (uint8 view).

        Reads past EOF zero-fill.  Returns bytes actually read from the store.
        """

    @abc.abstractmethod
    def write_from(self, offset: int, buf: np.ndarray) -> int:
        """Write ``len(buf)`` bytes from ``buf`` at ``offset``."""

    def read_into_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        """Read consecutive byte ranges starting at ``offset`` into each buf.

        ``bufs[0]`` receives bytes ``[offset, offset + bufs[0].nbytes)``,
        ``bufs[1]`` the next ``bufs[1].nbytes`` bytes, and so on — the
        scatter target for a coalesced run of adjacent pages (DESIGN.md §9).

        Default implementation loops :meth:`read_into` (one store operation
        per buf, so ``num_reads`` counts each); stores that can do better
        override it to issue a *single* operation — one syscall
        (``preadv``), one latency charge, one generator invocation — and
        count one read.  Returns total bytes read.
        """
        got, pos = 0, offset
        for b in bufs:
            got += self.read_into(pos, b)
            pos += b.nbytes
        return got

    def write_from_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        """Write consecutive byte ranges starting at ``offset`` from each buf
        — the gather source for a coalesced run of adjacent dirty pages
        (DESIGN.md §13).

        Default implementation loops :meth:`write_from` (one store operation
        per buf); stores that can do better override it to issue a *single*
        operation — one ``pwritev``, one extent walk, one latency charge —
        and count one write.  Returns total bytes written.
        """
        done, pos = 0, offset
        for b in bufs:
            done += self.write_from(pos, b)
            pos += b.nbytes
        return done

    def flush(self) -> None:  # pragma: no cover - default no-op
        pass

    def close(self) -> None:  # pragma: no cover - default no-op
        pass

    # --- instrumentation ----------------------------------------------------
    def reset_stats(self) -> None:
        self.bytes_read = 0
        self.bytes_written = 0
        self.num_reads = 0
        self.num_writes = 0

    def _count_read(self, n: int) -> None:
        self.bytes_read = getattr(self, "bytes_read", 0) + n
        self.num_reads = getattr(self, "num_reads", 0) + 1

    def _count_write(self, n: int) -> None:
        self.bytes_written = getattr(self, "bytes_written", 0) + n
        self.num_writes = getattr(self, "num_writes", 0) + 1


# ---------------------------------------------------------------------------


class FileStore(BackingStore):
    """Single-file store using positioned I/O on a raw fd."""

    batch_read_hint = 32     # one preadv amortizes a syscall per page
    batch_write_hint = 32    # one pwritev likewise

    # preadv/pwritev reject iovec lists longer than IOV_MAX (POSIX floor
    # and Linux value: 1024); batch calls chunk to this so callers with
    # unbounded buf lists (e.g. ckpt.save_tree_to_store on a many-leaf
    # pytree) don't hit EINVAL.
    _IOV_MAX = 1024

    def __init__(self, path: str, size: int | None = None, create: bool = False):
        self.path = str(path)
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self._fd = os.open(self.path, flags, 0o644)
        if size is not None and create:
            os.ftruncate(self._fd, size)
        self._size = size if size is not None else os.fstat(self._fd).st_size
        self.reset_stats()

    @property
    def size(self) -> int:
        return self._size

    def read_into(self, offset: int, buf: np.ndarray) -> int:
        want = buf.nbytes
        got = 0
        mv = memoryview(buf).cast("B")
        while got < want:
            chunk = os.pread(self._fd, min(want - got, 1 << 24), offset + got)
            if not chunk:
                break  # EOF — zero-fill the tail
            mv[got : got + len(chunk)] = chunk
            got += len(chunk)
        if got < want:
            mv[got:] = b"\x00" * (want - got)
        self._count_read(got)
        return got

    def read_into_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        """Vectorized: one ``preadv`` scatter-read for the whole run."""
        mvs = [memoryview(b).cast("B") for b in bufs]
        want = sum(m.nbytes for m in mvs)
        got = 0
        while got < want:
            # re-slice the iovec list past the bytes already read
            pending, skip = [], got
            for m in mvs:
                if skip >= m.nbytes:
                    skip -= m.nbytes
                    continue
                pending.append(m[skip:] if skip else m)
                skip = 0
            n = os.preadv(self._fd, pending[: self._IOV_MAX], offset + got)
            if n <= 0:
                break  # EOF — zero-fill the tail
            got += n
        if got < want:
            for m in _slice_bufs(bufs, got, want - got):
                m[:] = 0
        self._count_read(got)
        return got

    def write_from(self, offset: int, buf: np.ndarray) -> int:
        mv = memoryview(buf).cast("B")
        done = 0
        while done < len(mv):
            done += os.pwrite(self._fd, mv[done:], offset + done)
        self._count_write(done)
        return done

    def write_from_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        """Vectorized: one ``pwritev`` gather-write for the whole run."""
        mvs = [memoryview(b).cast("B") for b in bufs]
        want = sum(m.nbytes for m in mvs)
        done = 0
        while done < want:
            # re-slice the iovec list past the bytes already written
            pending, skip = [], done
            for m in mvs:
                if skip >= m.nbytes:
                    skip -= m.nbytes
                    continue
                pending.append(m[skip:] if skip else m)
                skip = 0
            n = os.pwritev(self._fd, pending[: self._IOV_MAX], offset + done)
            if n <= 0:  # pragma: no cover - pwritev never short-returns 0
                break
            done += n
        self._count_write(done)
        return done

    def flush(self) -> None:
        os.fsync(self._fd)

    def close(self) -> None:
        try:
            os.close(self._fd)
        except OSError:
            pass


class MultiFileStore(BackingStore):
    """Maps a set of file extents into one contiguous logical space.

    Paper §4.1: "Given a set of files, each with individual offsets and size,
    UMap maps them into a contiguous memory region."  A read that spans
    extents is split across the member stores (a page fault may require data
    from multiple files — paper §6.4).
    """

    def __init__(self, extents: Sequence[Tuple[BackingStore, int, int]]):
        # extents: (store, store_offset, length)
        self._extents: List[Tuple[BackingStore, int, int, int]] = []
        logical = 0
        for store, off, length in extents:
            self._extents.append((store, off, length, logical))
            logical += length
        self._size = logical
        self.reset_stats()

    @property
    def size(self) -> int:
        return self._size

    def _segments(self, offset: int, length: int):
        """Yield (store, store_off, buf_off, n) covering [offset, offset+length)."""
        for store, s_off, s_len, l_off in self._extents:
            lo = max(offset, l_off)
            hi = min(offset + length, l_off + s_len)
            if lo < hi:
                yield store, s_off + (lo - l_off), lo - offset, hi - lo

    def read_into(self, offset: int, buf: np.ndarray) -> int:
        mv = buf.view(np.uint8)
        got = 0
        for store, s_off, b_off, n in self._segments(offset, buf.nbytes):
            got += store.read_into(s_off, mv[b_off : b_off + n])
        if got < buf.nbytes:
            pass  # gaps/past-EOF zero-filled by member stores or left as-is
        self._count_read(got)
        return got

    def read_into_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        """Vectorized: one extent walk for the whole run; each overlapping
        extent receives a single (itself batched) member-store read instead
        of one call per page."""
        total = sum(b.nbytes for b in bufs)
        got = 0
        for store, s_off, b_off, n in self._segments(offset, total):
            got += store.read_into_batch(s_off, _slice_bufs(bufs, b_off, n))
        self._count_read(got)
        return got

    def write_from(self, offset: int, buf: np.ndarray) -> int:
        mv = buf.view(np.uint8)
        done = 0
        for store, s_off, b_off, n in self._segments(offset, buf.nbytes):
            done += store.write_from(s_off, mv[b_off : b_off + n])
        self._count_write(done)
        return done

    def write_from_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        """Vectorized: one extent walk for the whole run; each overlapping
        extent receives a single (itself batched) member-store write instead
        of one call per page."""
        total = sum(b.nbytes for b in bufs)
        done = 0
        for store, s_off, b_off, n in self._segments(offset, total):
            done += store.write_from_batch(s_off, _slice_bufs(bufs, b_off, n))
        self._count_write(done)
        return done

    def flush(self) -> None:
        for store, *_ in self._extents:
            store.flush()

    def close(self) -> None:
        for store, *_ in self._extents:
            store.close()


class HostArrayStore(BackingStore):
    """In-memory store over a numpy byte buffer (memory-server analogue)."""

    def __init__(self, data: np.ndarray):
        self._data = data.view(np.uint8).reshape(-1)
        self._lock = threading.Lock()
        self.reset_stats()

    @property
    def size(self) -> int:
        return self._data.nbytes

    def read_into(self, offset: int, buf: np.ndarray) -> int:
        mv = buf.view(np.uint8)
        n = max(0, min(mv.nbytes, self._data.nbytes - offset))
        mv[:n] = self._data[offset : offset + n]
        if n < mv.nbytes:
            mv[n:] = 0
        self._count_read(n)
        return n

    def read_into_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        """Vectorized: one pass over the array, counted as one read."""
        got, pos = 0, offset
        for b in bufs:
            mv = b.view(np.uint8)
            n = max(0, min(mv.nbytes, self._data.nbytes - pos))
            mv[:n] = self._data[pos : pos + n]
            if n < mv.nbytes:
                mv[n:] = 0
            got += n
            pos += mv.nbytes
        self._count_read(got)
        return got

    def write_from(self, offset: int, buf: np.ndarray) -> int:
        mv = buf.view(np.uint8)
        n = max(0, min(mv.nbytes, self._data.nbytes - offset))
        with self._lock:
            self._data[offset : offset + n] = mv[:n]
        self._count_write(n)
        return n

    def write_from_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        """Vectorized: one lock hold + one pass over the array, counted as
        one write."""
        done, pos = 0, offset
        with self._lock:
            for b in bufs:
                mv = b.view(np.uint8)
                n = max(0, min(mv.nbytes, self._data.nbytes - pos))
                self._data[pos : pos + n] = mv[:n]
                done += n
                pos += mv.nbytes
        self._count_write(done)
        return done


class RemoteStore(BackingStore):
    """Latency/bandwidth-modeled wrapper (Lustre / network HDD tier, §5).

    Each operation sleeps ``latency_s + bytes / bandwidth_Bps`` *outside* the
    wrapped store's own cost.  time.sleep releases the GIL, so concurrent
    fillers genuinely overlap remote reads — which is exactly the effect the
    paper's I/O decoupling (§3.2) exploits.
    """

    batch_read_hint = 64     # deep batches: one latency charge per run
    batch_write_hint = 64    # write-back runs likewise

    def __init__(self, inner: BackingStore, latency_s: float = 5e-3,
                 bandwidth_Bps: float = 200e6):
        self.inner = inner
        self.latency_s = latency_s
        self.bandwidth_Bps = bandwidth_Bps
        self.reset_stats()

    @property
    def size(self) -> int:
        return self.inner.size

    def _delay(self, nbytes: int) -> None:
        time.sleep(self.latency_s + nbytes / self.bandwidth_Bps)

    def read_into(self, offset: int, buf: np.ndarray) -> int:
        self._delay(buf.nbytes)
        n = self.inner.read_into(offset, buf)
        self._count_read(n)
        return n

    def read_into_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        """Vectorized: the whole run pays ONE round-trip latency charge plus
        streaming bandwidth — precisely the coalescing win the paper's I/O
        decoupling argument (§3.3) predicts for high-latency tiers."""
        self._delay(sum(b.nbytes for b in bufs))
        n = self.inner.read_into_batch(offset, bufs)
        self._count_read(n)
        return n

    def write_from(self, offset: int, buf: np.ndarray) -> int:
        self._delay(buf.nbytes)
        n = self.inner.write_from(offset, buf)
        self._count_write(n)
        return n

    def write_from_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        """Vectorized: the whole run pays ONE round-trip latency charge plus
        streaming bandwidth — the coalesced write-back win for high-latency
        tiers (DESIGN.md §13)."""
        self._delay(sum(b.nbytes for b in bufs))
        n = self.inner.write_from_batch(offset, bufs)
        self._count_write(n)
        return n

    def flush(self) -> None:
        self.inner.flush()

    def close(self) -> None:
        self.inner.close()


class SyntheticStore(BackingStore):
    """Procedural contents: ``generator(offset, buf)`` fills reads.

    Lets benchmarks address logical spaces far larger than the container disk
    (writes go to an overlay dict at page granularity).
    """

    batch_read_hint = 32     # one generator invocation per run
    batch_write_hint = 32    # one overlay walk per run

    def __init__(self, size: int, generator: Callable[[int, np.ndarray], None],
                 overlay_page: int = 1 << 20):
        self._size = size
        self._gen = generator
        self._overlay: dict[int, np.ndarray] = {}
        self._overlay_page = overlay_page
        self._lock = threading.Lock()
        self.reset_stats()

    @property
    def size(self) -> int:
        return self._size

    def _overlay_onto(self, offset: int, mv: np.ndarray) -> None:
        """Apply any overlayed (written) ranges onto generated bytes."""
        p = self._overlay_page
        first, last = offset // p, (offset + mv.nbytes - 1) // p
        with self._lock:
            for pg in range(first, last + 1):
                od = self._overlay.get(pg)
                if od is None:
                    continue
                lo = max(offset, pg * p)
                hi = min(offset + mv.nbytes, (pg + 1) * p)
                mv[lo - offset : hi - offset] = od[lo - pg * p : hi - pg * p]

    def read_into(self, offset: int, buf: np.ndarray) -> int:
        mv = buf.view(np.uint8)
        self._gen(offset, mv)
        self._overlay_onto(offset, mv)
        self._count_read(mv.nbytes)
        return mv.nbytes

    def read_into_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        """Vectorized: one generator call over the whole contiguous run,
        one overlay pass, then scatter into the page bufs."""
        total = sum(b.nbytes for b in bufs)
        scratch = np.empty(total, np.uint8)
        self._gen(offset, scratch)
        self._overlay_onto(offset, scratch)
        pos = 0
        for b in bufs:
            mv = b.view(np.uint8)
            mv[:] = scratch[pos : pos + mv.nbytes]
            pos += mv.nbytes
        self._count_read(total)
        return total

    def _write_overlay_locked(self, offset: int, mv: np.ndarray) -> None:
        """Scatter ``mv`` into overlay pages (``self._lock`` held)."""
        p = self._overlay_page
        pos = 0
        while pos < mv.nbytes:
            pg = (offset + pos) // p
            od = self._overlay.get(pg)
            if od is None:
                od = np.zeros(p, np.uint8)
                self._gen(pg * p, od)
                self._overlay[pg] = od
            lo = offset + pos
            hi = min((pg + 1) * p, offset + mv.nbytes)
            od[lo - pg * p : hi - pg * p] = mv[pos : pos + (hi - lo)]
            pos += hi - lo

    def write_from(self, offset: int, buf: np.ndarray) -> int:
        mv = buf.view(np.uint8)
        with self._lock:
            self._write_overlay_locked(offset, mv)
        self._count_write(mv.nbytes)
        return mv.nbytes

    def write_from_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        """Vectorized: one lock hold + one overlay walk for the whole run,
        counted as one write."""
        total, pos = 0, offset
        with self._lock:
            for b in bufs:
                mv = b.view(np.uint8)
                self._write_overlay_locked(pos, mv)
                total += mv.nbytes
                pos += mv.nbytes
        self._count_write(total)
        return total


def parse_tier_chain(spec: str) -> List[Tuple[str, tuple]]:
    """Parse a ``UMAP_TIER_CHAIN`` spec into cache-level descriptors.

    The spec names the CACHE levels of a :class:`TierChain`, fastest
    first, separated by commas; the base (capacity) tier is the store the
    chain is built over and never appears in the spec.  Each level is

      ``host:<size>``          an in-memory tier of ``<size>`` bytes
      ``file:<path>:<size>``   a file-backed tier at ``<path>``

    Sizes accept the usual suffixes (``64M``, ``2G``, ...).  Deliberately
    absent: any latency or bandwidth figure.  Tier speed is *sampled
    online* (an EWMA over observed I/O latency), never configured — a
    mis-declared constant would mis-place every extent, a sampler just
    converges (DESIGN.md §14.5).
    """
    from .config import parse_size
    levels: List[Tuple[str, tuple]] = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        parts = tok.split(":")
        kind = parts[0].strip().lower()
        if kind == "host" and len(parts) == 2:
            size = parse_size(parts[1])
            if size < 1:
                raise ValueError(f"tier level {tok!r}: size must be >= 1")
            levels.append(("host", (size,)))
        elif kind == "file" and len(parts) == 3:
            size = parse_size(parts[2])
            if size < 1:
                raise ValueError(f"tier level {tok!r}: size must be >= 1")
            levels.append(("file", (parts[1], size)))
        else:
            raise ValueError(
                f"bad tier level {tok!r} in UMAP_TIER_CHAIN spec "
                f"(want 'host:<size>' or 'file:<path>:<size>')")
    if not levels:
        raise ValueError("UMAP_TIER_CHAIN spec names no cache levels")
    return levels


def build_tier_stores(spec: str) -> List[BackingStore]:
    """Materialize the cache-level stores named by a ``UMAP_TIER_CHAIN``
    spec (fastest first).  The caller appends its base store to complete
    the chain: ``TierChain(build_tier_stores(spec) + [base], ...)``."""
    stores: List[BackingStore] = []
    for kind, args in parse_tier_chain(spec):
        if kind == "host":
            stores.append(HostArrayStore(np.zeros(args[0], np.uint8)))
        else:
            stores.append(FileStore(args[0], size=args[1], create=True))
    return stores


class TierChain(BackingStore):
    """An ordered chain of stores composed as a multi-level extent cache.

    Generalizes the paper's fast-over-slow pairing to N tiers (pmem →
    NVMe → network flash → HDD): the logical byte space is the LAST
    store's (the *base* tier, level ``len(stores)-1``), carved into
    fixed-size **extents**; every other store is a bounded cache level
    holding extent copies in slots.  Semantics (DESIGN.md §14):

      * **residency lattice** — each extent carries a validity bitmask
        (one bit per level; absent means base-only).  Every allocated
        slot holds a VALID copy; *dirty* means exactly "the base bit is
        unset" (some cache level has newer bytes than the base tier).
      * **read-through** — reads serve each extent from its fastest
        valid level; misses read the base tier (and, with
        ``promote_on_read`` and a free level-0 slot, promote inline —
        never evicting: eviction-based placement belongs to the pager's
        utility-driven migration engine).
      * **non-exclusive shadows** (Nomad, arxiv 2401.13154) — promotion
        COPIES; the source copy stays valid.  A demote with another valid
        copy is then a pure residency flip (no I/O); only the last copy
        of dirty bytes pays a write-back to the base tier.
        ``copy_on_demote=True`` forces the write-back always — the
        copy-always A/B baseline ``bench_tiering`` measures against.
      * **write-back / write-invalidate** — a write lands on the extent's
        fastest valid level and *invalidates* every other copy (their
        slots park on a stale list until in-flight readers drain, then
        free).  Writes to base-only extents go straight to the base tier
        (write-around), optionally promoting after (``promote_on_write``).
      * **transactional migration** — promote/demote/flush follow copy →
        verify generation → flip validity.  Writers bump the touched
        extents' generation BEFORE their I/O lands and hold a write pin
        until it completes; the single shared commit predicate
        (:meth:`_commit_ok_locked`) refuses both, so a concurrent fault
        can never observe a torn extent.  In-flight reads pin their
        extents, which blocks demotion (the only transition that
        invalidates bytes a reader may be using).
      * **online latency calibration** — every member-store I/O (user
        runs and staged migration copies) is timed into a per-level
        read/write EWMA (:meth:`sampled_latency`).  There is no
        configured latency anywhere; an unsampled tier reads as 0.0
        (optimistic) so the engine tries it and the first real I/O
        calibrates it.
      * **per-level degradation** — a cache level whose circuit breaker
        (duck-typed onto a ResilientStore-wrapped tier, DESIGN.md §17.5)
        is tripped routes around itself: redundant copies (a deeper valid
        copy exists) are dropped or bypassed, sole copies keep routing to
        the tripped tier — serving any other level would be silent
        staleness.

    Batched ops are split per level while *preserving* single-op
    coalescing: consecutive segments routed to the same level at
    contiguous device offsets collapse into one ``read_into_batch`` /
    ``write_from_batch`` member call.
    """

    def __init__(self, stores: Sequence[BackingStore],
                 extent_size: int = 1 << 20,
                 budgets: Optional[Sequence[Optional[int]]] = None,
                 promote_on_read: bool = True,
                 promote_on_write: bool = False,
                 copy_on_demote: bool = False,
                 ewma_alpha: float = 0.2):
        if len(stores) < 2:
            raise ValueError(
                f"TierChain needs >= 2 stores (cache..., base), "
                f"got {len(stores)}")
        if extent_size < 1:
            raise ValueError(f"extent_size must be >= 1, got {extent_size}")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        self._stores: List[BackingStore] = list(stores)
        self.num_levels = len(self._stores)
        self.base_level = self.num_levels - 1
        self._base_bit = 1 << self.base_level
        self.extent_size = extent_size
        self.num_extents = -(-self._stores[-1].size // extent_size)
        self.promote_on_read = promote_on_read
        self.promote_on_write = promote_on_write
        self.copy_on_demote = copy_on_demote
        self.ewma_alpha = ewma_alpha
        caches = self._stores[:-1]
        if budgets is None:
            budgets = [None] * len(caches)
        if len(budgets) != len(caches):
            raise ValueError(
                f"budgets ({len(budgets)}) must match cache levels "
                f"({len(caches)})")
        self._nslots: List[int] = []
        for lvl, (s, b) in enumerate(zip(caches, budgets)):
            budget = s.size if b is None else min(b, s.size)
            if budget < extent_size:
                raise ValueError(
                    f"fast-tier budget {budget} cannot hold one extent "
                    f"({extent_size} bytes)" if lvl == 0 else
                    f"tier budget {budget} at level {lvl} cannot hold one "
                    f"extent ({extent_size} bytes)")
            self._nslots.append(budget // extent_size)
        self.num_fast_slots = self._nslots[0]
        self.batch_read_hint = max(s.batch_read_hint for s in self._stores)
        self.batch_write_hint = max(s.batch_write_hint for s in self._stores)
        self._lock = threading.Lock()
        self._slots: List[dict] = [{} for _ in caches]   # [lvl] ext -> slot
        self._frees: List[List[int]] = [
            list(range(n - 1, -1, -1)) for n in self._nslots]
        # Slots invalidated by a write while readers may still be routed
        # to them ([lvl] ext -> [old slots]); reaped when pins drain.
        self._stale: List[dict] = [{} for _ in caches]
        self._valid: dict[int, int] = {}   # ext -> bitmask; absent = base-only
        self._dirty: set[int] = set()      # extents whose base bit is unset
        self._gen: dict[int, int] = {}     # write generation per extent
        self._pins: dict[int, int] = {}    # in-flight ops per extent
        # In-flight WRITES separately: a writer bumps the generation BEFORE
        # its I/O lands, so a migration's gen check alone cannot see a write
        # still in flight — its commit must also refuse write-pinned
        # extents or it would publish the pre-write bytes.
        self._wpins: dict[int, int] = {}
        self._pinned_fast: dict[int, int] = {}  # ext -> pin level ceiling
        self._cold: set[int] = set()            # tier_hint="cold" demote queue
        self.promotions = 0
        self.demotions = 0
        self.shadow_demotions = 0    # demotes that were pure residency flips
        self.migration_aborts = 0
        self.tier_failovers = 0      # redundant copies degraded off a dead tier
        self.promotions_by_level = [0] * self.num_levels
        self.demotions_by_level = [0] * self.num_levels
        self.read_bytes_by_level = [0] * self.num_levels
        self.migration_write_bytes_by_level = [0] * self.num_levels
        # Online per-level latency samplers: EWMA seconds/op, [lvl][read, write].
        self._lat_lock = threading.Lock()
        self._lat = [[0.0, 0.0] for _ in self._stores]
        self._lat_n = [[0, 0] for _ in self._stores]
        self._utility = [0.0] * self.num_levels  # published by the engine
        self.reset_stats()

    @classmethod
    def from_config(cls, base: BackingStore, config) -> "TierChain":
        """Build a chain over ``base`` from a :class:`UMapConfig`: the
        ``UMAP_TIER_CHAIN`` spec when set, else the deprecated two-tier
        ``UMAP_TIER_FAST_BYTES`` budget (≡ ``host:<bytes>``).

        Inline read-through promotion is OFF here: a config-built store is
        the pager pairing, where placement belongs to the migration
        engine — an inline promote would re-read the whole extent on the
        filler thread for every warm-up miss.
        """
        spec = getattr(config, "tier_chain", "")
        if not spec:
            if config.tier_fast_bytes >= 1:
                return TieredStore.from_config(base, config)
            raise ValueError(
                "tier_chain (UMAP_TIER_CHAIN) or tier_fast_bytes "
                "(UMAP_TIER_FAST_BYTES) must be set to build a TierChain "
                "from config")
        caches = build_tier_stores(spec)
        budget = min(s.size for s in caches)
        return cls(caches + [base],
                   extent_size=min(config.tier_extent_size, budget),
                   promote_on_read=False,
                   ewma_alpha=getattr(config, "tier_ewma_alpha", 0.2))

    # ----------------------------------------------------------- level access

    @property
    def size(self) -> int:
        return self._stores[-1].size

    @property
    def levels(self) -> Tuple[BackingStore, ...]:
        return tuple(self._stores)

    def set_level(self, level: int, store: BackingStore) -> None:
        """Replace one member store in place (the resilience layer wraps
        each level with its own breaker through this hook)."""
        self._stores[level] = store

    @property
    def fast(self) -> BackingStore:
        return self._stores[0]

    @fast.setter
    def fast(self, store: BackingStore) -> None:
        self._stores[0] = store

    @property
    def slow(self) -> BackingStore:
        return self._stores[-1]

    @slow.setter
    def slow(self, store: BackingStore) -> None:
        self._stores[-1] = store

    @property
    def fast_bytes_read(self) -> int:
        return self.read_bytes_by_level[0]

    @property
    def slow_bytes_read(self) -> int:
        return self.read_bytes_by_level[-1]

    # ------------------------------------------------------------ geometry

    def extent_of(self, offset: int) -> int:
        return offset // self.extent_size

    def _extent_nbytes(self, ext: int) -> int:
        return min(self.extent_size, self.size - ext * self.extent_size)

    # ------------------------------------------------- latency calibration

    def _note_latency(self, level: int, op: int, seconds: float) -> None:
        """Fold one observed I/O latency into the per-level EWMA (op 0 =
        read, 1 = write).  Called on every user-path run and every staged
        migration copy — tier speed is only ever observed, never
        configured."""
        with self._lat_lock:
            n = self._lat_n[level][op]
            if n == 0:
                self._lat[level][op] = seconds
            else:
                prev = self._lat[level][op]
                self._lat[level][op] = prev + self.ewma_alpha * (seconds - prev)
            self._lat_n[level][op] = n + 1

    def sampled_latency(self, level: int, op: str = "read") -> float:
        """EWMA of observed per-op latency at ``level``; 0.0 until the
        first sample (optimistic: an unsampled tier looks fast, so the
        engine tries it and the first real I/O calibrates it)."""
        i = 0 if op == "read" else 1
        return self._lat[level][i] if self._lat_n[level][i] else 0.0

    def note_utility(self, per_level: Sequence[float]) -> None:
        """Publish the migration engine's last aggregate utility per level
        (telemetry only; replaced wholesale each cycle)."""
        self._utility = [float(x) for x in per_level]

    # ------------------------------------------------------------- telemetry

    def resident_extents(self, level: int = 0) -> List[int]:
        with self._lock:
            return sorted(self._slots[level])

    def extent_level(self, ext: int) -> int:
        """The fastest level currently holding a valid copy of ``ext``."""
        with self._lock:
            mask = self._valid.get(ext, self._base_bit)
            return (mask & -mask).bit_length() - 1

    def tier_stats(self, relaxed: bool = False) -> dict:
        """Residency + migration counters + sampled latencies.

        ``relaxed=True`` skips ``self._lock``: each value is a single
        GIL-atomic read (``len()`` of a container or an int attribute), so
        every number was true at some instant, but the set is not a
        consistent cut — e.g. ``resident_extents`` and ``free_fast_slots``
        may transiently not sum to ``num_fast_slots`` mid-migration.  This
        is the telemetry scrape path (DESIGN.md §15.3): scrapes must never
        contend with promotion/demotion or the I/O planner for the lock.

        The base tier's residency is derived, not stored: an extent is
        base-resident unless dirty (dirty ≡ base bit unset), so its
        resident count is ``num_extents - dirty_extents``.
        """
        if relaxed:
            return {
                "resident_extents": len(self._slots[0]),
                "free_fast_slots": len(self._frees[0]),
                "dirty_extents": len(self._dirty),
                "pinned_fast": len(self._pinned_fast),
                "promotions": self.promotions,
                "demotions": self.demotions,
                "migration_aborts": self.migration_aborts,
                "tier_failovers": self.tier_failovers,
                "fast_bytes_read": self.read_bytes_by_level[0],
                "slow_bytes_read": self.read_bytes_by_level[-1],
                "levels": self.num_levels,
                "shadow_demotions": self.shadow_demotions,
                "resident_by_level": [len(s) for s in self._slots]
                                     + [self.num_extents - len(self._dirty)],
                "slots_by_level": list(self._nslots) + [self.num_extents],
                "free_by_level": [len(f) for f in self._frees] + [0],
                "promotions_by_level": list(self.promotions_by_level),
                "demotions_by_level": list(self.demotions_by_level),
                "read_bytes_by_level": list(self.read_bytes_by_level),
                "migration_write_bytes_by_level":
                    list(self.migration_write_bytes_by_level),
                "latency_read_s": [lat[0] for lat in self._lat],
                "latency_write_s": [lat[1] for lat in self._lat],
                "utility_by_level": list(self._utility),
            }
        with self._lock:
            return self.tier_stats(relaxed=True)

    def register_telemetry(self, registry=None,
                           label: Optional[str] = None) -> str:
        """Opt this store into the telemetry registry (DESIGN.md §15).

        Returns the registry name of the new tiering collector.  Note that
        ``PagingService.register_telemetry`` already auto-registers one
        collector per distinct tiered store it manages; this hook is for
        stores used directly (no service) or with a non-default registry.
        """
        from ..telemetry import default_registry
        from ..telemetry.collectors import TieringCollector
        reg = registry if registry is not None else default_registry()
        return reg.register(TieringCollector(self, label=label))

    # ------------------------------------------------------- segment routing

    def _level_down(self, level: int) -> bool:
        """True while ``level``'s circuit breaker (if any — duck-typed onto
        a ResilientStore-wrapped tier, DESIGN.md §17.5) is tripped: OPEN
        with its reset window not yet elapsed.  Once the window passes this
        goes False so reads/promotes resume sending (probe) traffic to the
        tier — routing on the raw OPEN state instead would starve the
        breaker of the very probes that let it recover."""
        br = getattr(self._stores[level], "breaker", None)
        if br is None:
            return False
        tripped = getattr(br, "tripped", None)
        return tripped() if tripped is not None else br.state == "open"

    def _fast_down(self) -> bool:
        return self._level_down(0)

    def _plan_locked(self, offset: int, length: int, write: bool):
        """Route ``[offset, offset+length)`` to per-level segments and pin
        the touched extents (``self._lock`` held).

        Returns ``(segments, extents)`` where each segment is ``(store,
        dev_off, buf_off, n, level)``.  Pins block demotion — the one
        migration step that would invalidate bytes under an in-flight op.

        Reads serve each extent's fastest valid level.  Writes land on the
        fastest valid level and invalidate every other copy (write-
        invalidate): stale cache slots park on ``_stale`` until the
        extent's pins drain — an in-flight reader may still be routed to
        them — then free.

        Degraded mode, per level: while a cache level's breaker is open,
        its REDUNDANT copies (a deeper valid copy exists) are dropped when
        no concurrent op is routed to their slot (freeing the slot for
        re-admission when the breaker recovers, ``tier_failovers``), else
        reads route around them.  A copy that is the ONLY copy — dirty
        bytes not yet written back — keeps routing to (and failing
        against) the tripped tier: serving any other level would be silent
        staleness, so the error instead propagates to the pager, whose
        retry/quarantine path keeps the page buffer copy authoritative.
        """
        segs: List[Tuple[BackingStore, int, int, int, int]] = []
        exts: List[int] = []
        pos = offset
        end = offset + length
        down = [self._level_down(lvl) for lvl in range(self.base_level)]
        any_down = any(down)
        while pos < end:
            ext = pos // self.extent_size
            hi = min(end, (ext + 1) * self.extent_size)
            n = hi - pos
            pins_before = self._pins.get(ext, 0)
            self._pins[ext] = pins_before + 1
            if write:
                self._wpins[ext] = self._wpins.get(ext, 0) + 1
            exts.append(ext)
            mask = self._valid.get(ext, self._base_bit)
            route_mask = mask
            if any_down and mask != self._base_bit:
                for lvl in range(self.base_level):
                    bit = 1 << lvl
                    if not (mask & bit) or not down[lvl]:
                        continue
                    deeper = mask & ~((bit << 1) - 1)
                    if not deeper:
                        continue                 # only copy: must serve it
                    if (pins_before == 0 and
                            self._wpins.get(ext, 0) <= (1 if write else 0)):
                        # No concurrent op routed to this slot: drop the
                        # redundant copy so this op and all successors use
                        # a live level and the slot is reclaimable.
                        slot = self._slots[lvl].pop(ext)
                        self._frees[lvl].append(slot)
                        mask &= ~bit
                        route_mask &= ~bit
                        self.tier_failovers += 1
                    elif not write:
                        # Slot busy under concurrent pins — leave the copy,
                        # but serve this read from a deeper valid level.
                        route_mask &= ~bit
                if mask == self._base_bit:
                    self._valid.pop(ext, None)
                elif mask != self._valid.get(ext, self._base_bit):
                    self._valid[ext] = mask
            lvl = (route_mask & -route_mask).bit_length() - 1
            if write:
                # Write-invalidate: every OTHER copy goes stale.  Slots are
                # not freed inline — an in-flight read may be routed to
                # them — but parked until the extent's pins drain.
                if mask != (1 << lvl):
                    for l2 in range(self.base_level):
                        bit = 1 << l2
                        if l2 != lvl and (mask & bit):
                            slot = self._slots[l2].pop(ext)
                            self._stale[l2].setdefault(ext, []).append(slot)
                if lvl == self.base_level:
                    self._valid.pop(ext, None)     # canonical base-only
                else:
                    self._dirty.add(ext)
                    self._valid[ext] = 1 << lvl
                self._gen[ext] = self._gen.get(ext, 0) + 1
            if lvl == self.base_level:
                segs.append((self._stores[-1], pos, pos - offset, n, lvl))
            else:
                slot = self._slots[lvl][ext]
                dev = slot * self.extent_size + (pos - ext * self.extent_size)
                segs.append((self._stores[lvl], dev, pos - offset, n, lvl))
            if not write:
                self.read_bytes_by_level[lvl] += n
            pos = hi
        return segs, exts

    def _unpin(self, exts: Iterable[int], write: bool = False) -> None:
        with self._lock:
            for ext in exts:
                left = self._pins.get(ext, 0) - 1
                if left > 0:
                    self._pins[ext] = left
                else:
                    self._pins.pop(ext, None)
                    # Last pin gone: no reader can be routed to a stale
                    # slot any more — reap them back to the free lists.
                    for lvl, stale in enumerate(self._stale):
                        slots = stale.pop(ext, None)
                        if slots:
                            self._frees[lvl].extend(slots)
                if write:
                    wleft = self._wpins.get(ext, 0) - 1
                    if wleft > 0:
                        self._wpins[ext] = wleft
                    else:
                        self._wpins.pop(ext, None)

    @staticmethod
    def _runs(segs):
        """Collapse consecutive same-store, device-contiguous segments into
        runs — the per-level preservation of single-op coalescing."""
        run: List[Tuple[BackingStore, int, int, int, int]] = []
        for seg in segs:
            if run and (seg[0] is run[-1][0]
                        and seg[1] == run[-1][1] + run[-1][3]):
                run.append(seg)
            else:
                if run:
                    yield run
                run = [seg]
        if run:
            yield run

    # ---------------------------------------------------------------- reads

    def read_into(self, offset: int, buf: np.ndarray) -> int:
        return self.read_into_batch(offset, [buf])

    def read_into_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        total = sum(b.nbytes for b in bufs)
        n = max(0, min(total, self.size - offset))
        if n < total:
            for m in _slice_bufs(bufs, n, total - n):
                m[:] = 0
        if n == 0:
            self._count_read(0)
            return 0
        with self._lock:
            segs, exts = self._plan_locked(offset, n, write=False)
        try:
            # I/O outside the residency lock; pins keep the routing valid.
            for run in self._runs(segs):
                store, dev, b_off, _, lvl = run[0]
                length = sum(s[3] for s in run)
                t0 = time.perf_counter()
                store.read_into_batch(dev, _slice_bufs(bufs, b_off, length))
                self._note_latency(lvl, 0, time.perf_counter() - t0)
        finally:
            self._unpin(exts)
        self._count_read(n)
        if self.promote_on_read:
            self._promote_misses(offset, n)
        return n

    def _promote_misses(self, offset: int, length: int) -> None:
        """Inline read-through promotion: only into FREE level-0 slots,
        never evicting (eviction-based placement is the migration
        engine's job)."""
        first = offset // self.extent_size
        last = (offset + length - 1) // self.extent_size
        for ext in range(first, last + 1):
            with self._lock:
                if (self._valid.get(ext, self._base_bit) & 1
                        or not self._frees[0]):
                    continue
            self.promote(ext)

    # ---------------------------------------------------------------- writes

    def write_from(self, offset: int, buf: np.ndarray) -> int:
        return self.write_from_batch(offset, [buf])

    def write_from_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        total = sum(b.nbytes for b in bufs)
        n = max(0, min(total, self.size - offset))
        if n == 0:
            self._count_write(0)
            return 0
        with self._lock:
            segs, exts = self._plan_locked(offset, n, write=True)
        try:
            for run in self._runs(segs):
                store, dev, b_off, _, lvl = run[0]
                length = sum(s[3] for s in run)
                t0 = time.perf_counter()
                store.write_from_batch(dev, _slice_bufs(bufs, b_off, length))
                self._note_latency(lvl, 1, time.perf_counter() - t0)
        finally:
            self._unpin(exts, write=True)
        self._count_write(n)
        if self.promote_on_write:
            self._promote_misses(offset, n)
        return n

    # -------------------------------------------- migration (DESIGN.md §14.2)

    def _commit_ok_locked(self, ext: int, gen0: int,
                          need_unpinned: bool = False) -> bool:
        """THE migration commit predicate (``self._lock`` held), shared by
        inline read-through promotion, the engine's promote/demote, and
        flush: a staged copy is publishable iff no write completed since
        it was taken (the generation check) AND no write is still in
        flight (a writer bumps the generation BEFORE its I/O lands, so the
        generation alone cannot see it — ``_wpins`` can).  Demotion
        additionally requires the extent unpinned: it frees a slot an
        in-flight reader may still be routed to."""
        if self._gen.get(ext, 0) != gen0 or self._wpins.get(ext, 0) > 0:
            return False
        if need_unpinned and self._pins.get(ext, 0) > 0:
            return False
        return True

    def _stage_extent_copy(self, ext: int, src_level: int, src_off: int,
                           dst_level: int, dst_off: int) -> None:
        """Copy one extent's bytes between levels through a staging
        buffer, timing both sides into the latency samplers.  Single-op
        member calls (not the batch path) so fault-injection wrappers and
        per-tier hooks intercept exactly one tier's I/O."""
        nbytes = self._extent_nbytes(ext)
        staging = np.empty(nbytes, np.uint8)
        t0 = time.perf_counter()
        self._stores[src_level].read_into(src_off, staging)
        t1 = time.perf_counter()
        self._note_latency(src_level, 0, t1 - t0)
        self._stores[dst_level].write_from(dst_off, staging)
        self._note_latency(dst_level, 1, time.perf_counter() - t1)
        self.migration_write_bytes_by_level[dst_level] += nbytes

    def promote(self, ext: int, level: int = 0) -> bool:
        """Copy an extent's bytes to cache ``level``: copy → verify
        generation → flip validity.  Non-exclusive: the source copy stays
        valid (a shadow), so a later clean demote is a pure residency
        flip.  ``level`` may also be SLOWER than the extent's current
        fastest — that pre-demote shadow copy is how the engine moves an
        extent down the chain without a base-tier write-back.

        Returns False when the extent is already valid at ``level``, no
        slot is free there, the level's breaker is tripped, or a
        concurrent write raced the staging copy — the caller (migration
        engine) simply retries a later cycle.  Concurrent *reads* need no
        guard: they route to the existing valid copies until the flip.
        """
        if not 0 <= ext < self.num_extents:
            return False
        if not 0 <= level < self.base_level:
            return False
        if self._level_down(level):
            return False     # no admissions into a tripped tier; half-open
            #                  probes re-enable promotion (re-admission path)
        with self._lock:
            mask = self._valid.get(ext, self._base_bit)
            if mask & (1 << level) or not self._frees[level]:
                return False
            gen0 = self._gen.get(ext, 0)
            slot = self._frees[level].pop()  # reserve: invisible until flip
            src = (mask & -mask).bit_length() - 1
            src_off = (ext * self.extent_size if src == self.base_level
                       else self._slots[src][ext] * self.extent_size)
            # Pin: blocks demotion of the source copy (and degraded-mode
            # drops) while the staging read is in flight.
            self._pins[ext] = self._pins.get(ext, 0) + 1
        try:
            self._stage_extent_copy(ext, src, src_off, level,
                                    slot * self.extent_size)
        except Exception:
            with self._lock:
                self._frees[level].append(slot)
            raise
        finally:
            self._unpin([ext])
        with self._lock:
            mask = self._valid.get(ext, self._base_bit)
            if not self._commit_ok_locked(ext, gen0) or mask & (1 << level):
                self._frees[level].append(slot)  # raced a write: abort
                self.migration_aborts += 1
                return False
            self._slots[level][ext] = slot
            self._valid[ext] = mask | (1 << level)
            self.promotions += 1
            self.promotions_by_level[level] += 1
            return True

    def demote(self, ext: int, level: Optional[int] = None) -> bool:
        """Drop an extent's copy at cache ``level`` (default: its fastest
        valid cache level).  With another valid copy the drop is a pure
        residency flip — the non-exclusive shadow makes a clean demote
        free.  Only the LAST copy of dirty bytes pays a write-back to the
        base tier: copy → verify generation → flip → free slot.
        ``copy_on_demote=True`` forces the write-back always (the
        copy-always A/B baseline).

        Refuses pinned extents — a pin marks an in-flight op routed to
        the slot this demotion would free — and drops that would leave a
        ``pin_fast`` extent with no copy at or above its pin level.
        """
        with self._lock:
            mask = self._valid.get(ext, self._base_bit)
            cache_mask = mask & ~self._base_bit
            if level is None:
                if not cache_mask:
                    return False
                level = (cache_mask & -cache_mask).bit_length() - 1
            bit = 1 << level
            slot = (self._slots[level].get(ext)
                    if 0 <= level < self.base_level else None)
            if slot is None or self._pins.get(ext, 0) > 0:
                return False
            pin_level = self._pinned_fast.get(ext)
            if pin_level is not None:
                rest = (mask & ~bit) & ((1 << (pin_level + 1)) - 1)
                if not rest:
                    return False   # would strand the pin below its ceiling
            rest_mask = mask & ~bit
            if rest_mask and not self.copy_on_demote:
                # Shadow flip: another copy is valid and (invariant)
                # byte-identical, so the demote is pure metadata — no I/O.
                del self._slots[level][ext]
                self._frees[level].append(slot)
                if rest_mask == self._base_bit:
                    self._valid.pop(ext, None)
                else:
                    self._valid[ext] = rest_mask
                self.demotions += 1
                self.demotions_by_level[level] += 1
                self.shadow_demotions += 1
                return True
            gen0 = self._gen.get(ext, 0)
        # Last (or copy-always) copy: write back to the base tier first.
        self._stage_extent_copy(ext, level, slot * self.extent_size,
                                self.base_level, ext * self.extent_size)
        with self._lock:
            if (not self._commit_ok_locked(ext, gen0, need_unpinned=True)
                    or self._slots[level].get(ext) != slot):
                self.migration_aborts += 1   # raced a write/read: abort
                return False
            del self._slots[level][ext]
            self._frees[level].append(slot)
            mask = self._valid.get(ext, self._base_bit)
            rest_mask = (mask | self._base_bit) & ~bit
            if rest_mask == self._base_bit:
                self._valid.pop(ext, None)
            else:
                self._valid[ext] = rest_mask
            self._dirty.discard(ext)
            self.demotions += 1
            self.demotions_by_level[level] += 1
            return True

    def free_fast_slots(self) -> int:
        with self._lock:
            return len(self._frees[0])

    def free_slots(self, level: int) -> int:
        with self._lock:
            return len(self._frees[level])

    # ------------------------------------------------ tier hints (§14.3)

    def pin_fast(self, extents: Iterable[int], level: int = 0) -> None:
        """Pin extents at or above cache ``level`` (``tier_hint=
        "pin_fast"`` / ``"pin_fast:<level>"``): demotion refuses to drop
        their last copy within the ceiling; the migration engine promotes
        them at top priority."""
        level = max(0, min(int(level), self.base_level - 1))
        with self._lock:
            for e in extents:
                if 0 <= e < self.num_extents:
                    self._pinned_fast[e] = level

    def unpin_fast(self, extents: Iterable[int]) -> None:
        with self._lock:
            for e in extents:
                self._pinned_fast.pop(e, None)

    def mark_cold(self, extents: Iterable[int]) -> None:
        """Queue extents for demotion (``tier_hint="cold"``); the migration
        engine drains the queue on its next cycle."""
        with self._lock:
            cold = [e for e in extents if 0 <= e < self.num_extents]
            self._cold.update(cold)
            for e in cold:
                self._pinned_fast.pop(e, None)

    def take_cold_hints(self) -> List[int]:
        with self._lock:
            out = sorted(self._cold)
            self._cold.clear()
            return out

    def pinned_fast_extents(self) -> List[int]:
        with self._lock:
            return sorted(self._pinned_fast)

    def pin_levels(self) -> dict:
        """Snapshot of ``ext -> pin level ceiling`` for the engine."""
        with self._lock:
            return dict(self._pinned_fast)

    # ----------------------------------------------------------------- flush

    def flush(self) -> None:
        """Write every dirty extent's bytes back to the base tier, then
        flush every level (extents stay resident — flush is not
        demotion)."""
        while True:
            with self._lock:
                dirty = []
                for e in sorted(self._dirty):
                    cm = self._valid.get(e, self._base_bit) & ~self._base_bit
                    src = (cm & -cm).bit_length() - 1
                    dirty.append((e, src, self._slots[src][e],
                                  self._gen.get(e, 0)))
            if not dirty:
                break
            for ext, src, slot, gen0 in dirty:
                # Pin before the staging copy: a concurrent demote would
                # free the slot (and a promote could reuse it for a
                # DIFFERENT extent — the gen check alone cannot see that);
                # pins block demotion, so slot identity is stable below.
                with self._lock:
                    if self._slots[src].get(ext) != slot:
                        continue      # migrated since the snapshot
                    self._pins[ext] = self._pins.get(ext, 0) + 1
                try:
                    self._stage_extent_copy(ext, src, slot * self.extent_size,
                                            self.base_level,
                                            ext * self.extent_size)
                finally:
                    self._unpin([ext])
                with self._lock:
                    if self._commit_ok_locked(ext, gen0):
                        self._dirty.discard(ext)
                        mask = self._valid.get(ext, self._base_bit)
                        mask |= self._base_bit
                        if mask == self._base_bit:
                            self._valid.pop(ext, None)
                        else:
                            self._valid[ext] = mask
                    # else: re-dirtied mid-copy — the outer loop re-runs
        for s in self._stores:
            s.flush()

    def close(self) -> None:
        for s in self._stores:
            s.close()


class TieredStore(TierChain):
    """The original two-tier API, now a depth-2 facade over
    :class:`TierChain`: ``TieredStore(fast, slow)`` composes a FAST store
    as an extent-granular cache over a SLOW store with a fixed fast-tier
    byte budget.  All semantics — read-through, write-back, transactional
    promote/demote, degraded-mode failover — are the chain's (see
    :class:`TierChain` and DESIGN.md §14); ``fast``/``slow`` alias levels
    0 and 1.
    """

    def __init__(self, fast: BackingStore, slow: BackingStore,
                 fast_bytes: Optional[int] = None,
                 extent_size: int = 1 << 20,
                 promote_on_read: bool = True,
                 promote_on_write: bool = False):
        if extent_size < 1:
            raise ValueError(f"extent_size must be >= 1, got {extent_size}")
        budget = fast.size if fast_bytes is None else min(fast_bytes, fast.size)
        super().__init__([fast, slow], extent_size=extent_size,
                         budgets=[budget],
                         promote_on_read=promote_on_read,
                         promote_on_write=promote_on_write)

    @classmethod
    def from_config(cls, slow: BackingStore, config,
                    fast: Optional[BackingStore] = None) -> "TieredStore":
        """Build a two-tier store from a :class:`UMapConfig`'s tier budget
        (``UMAP_TIER_FAST_BYTES`` / ``UMAP_TIER_EXTENT``); ``fast``
        defaults to a host-memory tier of exactly the budget.

        .. deprecated:: the byte-budget pair is the legacy spelling of a
           depth-2 chain — ``UMAP_TIER_FAST_BYTES=64M`` is exactly
           ``UMAP_TIER_CHAIN=host:64M``.  New configs should set
           ``UMAP_TIER_CHAIN`` (see :func:`parse_tier_chain`); the old
           knobs keep working through this shim.

        Inline read-through promotion is OFF here: a config-built store is
        the pager pairing, where placement belongs to the migration
        engine — an inline promote would re-read the whole extent on the
        filler thread for every warm-up miss (extent-size / page-size read
        amplification on the demand path).
        """
        budget = config.tier_fast_bytes
        if budget < 1:
            raise ValueError(
                "tier_fast_bytes (UMAP_TIER_FAST_BYTES) must be set to "
                "build a TieredStore from config")
        if fast is None:
            fast = HostArrayStore(np.zeros(budget, np.uint8))
        return cls(fast, slow, fast_bytes=budget,
                   extent_size=min(config.tier_extent_size, budget),
                   promote_on_read=False)


class FaultyStore(BackingStore):
    """Fault-injection wrapper: fail I/O after N successful operations.

    The regression harness for the end-to-end error-propagation contract
    (DESIGN.md §14.4): wrap any store, let ``fail_after_reads`` /
    ``fail_after_writes`` operations succeed, then raise ``exc_type`` on
    the following ``fail_count`` operations (default: forever).  Batch ops
    count as ONE operation, mirroring their single-syscall semantics.
    Thread-safe; ``reads_attempted`` / ``writes_attempted`` include the
    failed operations.
    """

    def __init__(self, inner: BackingStore,
                 fail_after_reads: Optional[int] = None,
                 fail_after_writes: Optional[int] = None,
                 fail_count: Optional[int] = None,
                 exc_type: type = OSError):
        self.inner = inner
        self.fail_after_reads = fail_after_reads
        self.fail_after_writes = fail_after_writes
        self.fail_count = fail_count
        self.exc_type = exc_type
        self.batch_read_hint = inner.batch_read_hint
        self.batch_write_hint = inner.batch_write_hint
        self._lock = threading.Lock()
        self.reads_attempted = 0
        self.writes_attempted = 0
        self.reads_failed = 0
        self.writes_failed = 0
        self.reset_stats()

    @property
    def size(self) -> int:
        return self.inner.size

    def _gate(self, kind: str) -> None:
        with self._lock:
            attempted = getattr(self, f"{kind}s_attempted")
            setattr(self, f"{kind}s_attempted", attempted + 1)
            threshold = getattr(self, f"fail_after_{kind}s")
            if threshold is None or attempted < threshold:
                return
            failed = getattr(self, f"{kind}s_failed")
            if self.fail_count is not None and failed >= self.fail_count:
                return
            setattr(self, f"{kind}s_failed", failed + 1)
        raise self.exc_type(
            f"injected {kind} failure #{failed + 1} after "
            f"{threshold} successful {kind}s")

    def read_into(self, offset: int, buf: np.ndarray) -> int:
        self._gate("read")
        n = self.inner.read_into(offset, buf)
        self._count_read(n)
        return n

    def read_into_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        self._gate("read")
        n = self.inner.read_into_batch(offset, bufs)
        self._count_read(n)
        return n

    def write_from(self, offset: int, buf: np.ndarray) -> int:
        self._gate("write")
        n = self.inner.write_from(offset, buf)
        self._count_write(n)
        return n

    def write_from_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        self._gate("write")
        n = self.inner.write_from_batch(offset, bufs)
        self._count_write(n)
        return n

    def flush(self) -> None:
        self.inner.flush()

    def close(self) -> None:
        self.inner.close()
