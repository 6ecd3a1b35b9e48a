"""Resilient I/O layer between the pager and any :class:`BackingStore`
(DESIGN.md §17).

UMap's target deployments span node-local pmem to network-interconnected
flash, where transient I/O failure and latency spikes are the norm.  PR 5's
failure contract only *surfaces* store errors; this module makes the stack
*survive* them:

  ResilientStore   wraps any store with per-op deadlines, bounded
                   exponential-backoff-with-jitter retries (transient vs
                   permanent taxonomy), hedged reads for high-latency tiers,
                   optional per-block CRC read verification, and a per-store
                   circuit breaker (closed -> open -> half-open with health
                   probes).
  CircuitBreaker   the breaker state machine, usable standalone; listeners
                   fire on state transitions (the pager uses an
                   open -> closed listener to re-post quarantined pages).
  RetryPolicy      the shared retry/backoff/classification knobs.
  ChaosStore       fault-injection harness generalizing FaultyStore:
                   seeded probabilistic transient/permanent errors, latency
                   spikes, torn writes, bit flips, and scripted ``kill()`` /
                   ``revive()`` tier outages for the chaos benchmark.

Error taxonomy (see :func:`default_classify`): transient errors are retried
with backoff inside the op deadline; permanent errors are raised immediately.
``CorruptPageError`` (checksum mismatch) is transient — a retry re-reads the
bytes, which heals one-shot corruption such as a torn read or an in-flight
bit flip.  ``BreakerOpenError`` is raised *without* consuming retry budget
when the breaker rejects an op; callers one level up (the pager's fill
retry loop, or ``TieredStore``'s re-plan) treat it as transient because a
retry can be served by a different tier.
"""

from __future__ import annotations

import errno as _errno
import random
import threading
import time
import zlib
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .store import BackingStore, _slice_bufs

__all__ = [
    "BreakerOpenError",
    "ChaosStore",
    "CircuitBreaker",
    "CorruptPageError",
    "ResilientStore",
    "RetryPolicy",
    "default_classify",
]


class CorruptPageError(IOError):
    """A read returned bytes whose checksum does not match the last known
    good CRC for that block (torn read, bit flip, stale replica).  Transient:
    a retry re-reads the store and usually heals it."""


class BreakerOpenError(IOError):
    """The store's circuit breaker is open: the op was rejected without
    touching the store.  Never retried *within* a ResilientStore op (the
    breaker would reject again); retriable one level up where a re-plan can
    route around the dead store."""


#: OSError errnos that indicate a permanent, non-retriable condition.
_PERMANENT_ERRNOS = frozenset(
    e for e in (
        _errno.EACCES, _errno.EPERM, _errno.ENOENT, _errno.EBADF,
        _errno.EINVAL, _errno.ENOSPC, _errno.EROFS, _errno.EISDIR,
    )
)

#: Exception types that are permanent regardless of errno — programming or
#: configuration errors a retry cannot fix.
_PERMANENT_TYPES = (
    ValueError, TypeError, KeyError, IndexError, AttributeError,
    NotImplementedError, PermissionError, FileNotFoundError, IsADirectoryError,
)


def default_classify(exc: BaseException) -> bool:
    """Return True if ``exc`` is transient (worth retrying).

    Taxonomy (DESIGN.md §17.2):
      * ``CorruptPageError`` — transient (re-read heals one-shot corruption).
      * ``BreakerOpenError`` — transient *for callers above the wrapper*
        (a re-plan may route to another tier); the wrapper itself never
        retries it.
      * ``OSError`` with a permanent errno (EACCES, ENOENT, ENOSPC, ...) —
        permanent.  Any other OSError/IOError/TimeoutError — transient
        (EIO, EAGAIN, injected faults with no errno, link timeouts).
      * Programming errors (ValueError, TypeError, ...) — permanent.
    """
    if isinstance(exc, (CorruptPageError, BreakerOpenError)):
        return True
    if isinstance(exc, _PERMANENT_TYPES):
        return False
    if isinstance(exc, OSError):
        return exc.errno not in _PERMANENT_ERRNOS
    return isinstance(exc, TimeoutError)


@dataclass
class RetryPolicy:
    """Bounded exponential backoff with jitter under a whole-op deadline."""

    retries: int = 3              # retry attempts after the first try
    backoff_s: float = 0.002      # initial sleep before retry 1
    max_backoff_s: float = 0.1    # exponential growth cap
    jitter: float = 0.5           # sleep *= 1 + U(0, jitter)
    deadline_s: float = 2.0       # wall-clock budget for the whole op
    classify: Callable[[BaseException], bool] = field(default=default_classify)

    def sleep_s(self, attempt: int, rng: random.Random) -> float:
        base = min(self.backoff_s * (2 ** attempt), self.max_backoff_s)
        return base * (1.0 + self.jitter * rng.random())


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: Numeric encoding for the telemetry gauge (0 healthy .. 2 tripped).
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """closed -> open -> half-open state machine with health probes.

    ``threshold`` consecutive failures trip the breaker OPEN; while open,
    :meth:`allow` rejects everything until ``reset_s`` has elapsed, then the
    breaker HALF-OPENs and admits up to ``probes`` concurrent health probes.
    ``probes`` consecutive probe successes close it; one probe failure
    re-opens it (and restarts the reset clock).

    Listeners registered with :meth:`add_listener` are invoked as
    ``fn(old_state, new_state)`` *after* the transition, outside the breaker
    lock, from the I/O thread that caused it — they must not block and must
    not raise (exceptions are swallowed).
    """

    def __init__(self, threshold: int = 5, reset_s: float = 0.5,
                 probes: int = 2, clock: Callable[[], float] = time.monotonic):
        self.threshold = max(1, int(threshold))
        self.reset_s = float(reset_s)
        self.probes = max(1, int(probes))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0             # consecutive failures while closed
        self._probe_ok = 0             # consecutive successes while half-open
        self._probe_inflight = 0
        self._opened_at = 0.0
        self._open_accum_s = 0.0       # cumulative seconds spent OPEN
        self._listeners: List[Callable[[str, str], None]] = []
        self.opens = 0
        self.half_opens = 0
        self.closes = 0

    # -- state ---------------------------------------------------------------

    @property
    def state(self) -> str:
        return self._state

    @property
    def state_code(self) -> int:
        return _STATE_CODE[self._state]

    def tripped(self) -> bool:
        """True while ops should be routed *away* without even probing:
        OPEN with the reset window not yet elapsed.  Once ``reset_s``
        passes this returns False so callers resume sending traffic —
        it is exactly that traffic, gated through :meth:`allow`, that
        advances OPEN -> HALF_OPEN -> CLOSED.  (Routing on the raw
        ``state`` instead would deadlock: no traffic -> no probes -> the
        breaker never leaves OPEN.)"""
        with self._lock:
            return (self._state == OPEN
                    and self._clock() - self._opened_at < self.reset_s)

    def open_seconds(self) -> float:
        """Cumulative seconds this breaker has spent OPEN (degraded)."""
        with self._lock:
            extra = (self._clock() - self._opened_at
                     if self._state == OPEN else 0.0)
            return self._open_accum_s + extra

    def add_listener(self, fn: Callable[[str, str], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[str, str], None]) -> None:
        with self._lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    # -- transitions (caller holds self._lock) -------------------------------

    def _transition_locked(self, new: str) -> Optional[Tuple[str, str]]:
        old = self._state
        if old == new:
            return None
        if old == OPEN:
            self._open_accum_s += self._clock() - self._opened_at
        if new == OPEN:
            self._opened_at = self._clock()
            self.opens += 1
        elif new == HALF_OPEN:
            self.half_opens += 1
            self._probe_ok = 0
            self._probe_inflight = 0
        elif new == CLOSED:
            self.closes += 1
            self._failures = 0
        self._state = new
        return (old, new)

    def _fire(self, edge: Optional[Tuple[str, str]]) -> None:
        if edge is None:
            return
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(*edge)
            except Exception:       # noqa: BLE001 — listeners must not kill I/O
                pass

    # -- protocol ------------------------------------------------------------

    def allow(self) -> bool:
        """Gate an op: True to proceed (a half-open True reserves a probe
        slot — the caller MUST follow with record_success/record_failure)."""
        edge = None
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.reset_s:
                    return False
                edge = self._transition_locked(HALF_OPEN)
            # HALF_OPEN: admit a bounded number of concurrent probes
            if self._probe_inflight < self.probes:
                self._probe_inflight += 1
                ok = True
            else:
                ok = False
        self._fire(edge)
        return ok

    def record_success(self) -> None:
        edge = None
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_inflight = max(0, self._probe_inflight - 1)
                self._probe_ok += 1
                if self._probe_ok >= self.probes:
                    edge = self._transition_locked(CLOSED)
            elif self._state == CLOSED:
                self._failures = 0
        self._fire(edge)

    def record_failure(self) -> None:
        edge = None
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_inflight = max(0, self._probe_inflight - 1)
                edge = self._transition_locked(OPEN)
            elif self._state == CLOSED:
                self._failures += 1
                if self._failures >= self.threshold:
                    edge = self._transition_locked(OPEN)
        self._fire(edge)

    def stats(self) -> Dict[str, float]:
        return {
            "breaker_state": self.state_code,
            "breaker_opens": self.opens,
            "breaker_half_opens": self.half_opens,
            "breaker_closes": self.closes,
            "degraded_seconds": self.open_seconds(),
        }


# ---------------------------------------------------------------------------
# ResilientStore
# ---------------------------------------------------------------------------

_RESILIENCE_COUNTERS = (
    "retries", "retries_ok", "exhausted", "permanent_errors",
    "breaker_rejections", "hedges", "hedge_wins", "checksum_failures",
    "deadline_exceeded",
)


class ResilientStore(BackingStore):
    """Retry / hedge / checksum / breaker wrapper around any store.

    Every read/write routes through one retry loop: breaker gate, the inner
    op, optional CRC verification, transient/permanent classification, then
    exponential backoff with jitter bounded by both the retry budget and a
    whole-op deadline.  A tripped breaker turns subsequent ops into
    fail-fast :class:`BreakerOpenError` until the reset timeout half-opens
    it for health probes.

    ``verify_reads`` keeps a CRC32 per aligned ``checksum_block``-byte block,
    recorded on full-block writes and first full-block reads and verified on
    every later full-block read; a mismatch raises :class:`CorruptPageError`
    (transient — the retry re-reads).  Partial-block writes invalidate the
    block's CRC rather than guessing.

    ``hedge_delay_s`` enables hedged reads: if the primary read has not
    completed within the delay, a second identical read is issued and the
    first to succeed wins.  Both attempts target private scratch buffers so
    the loser can never tear the caller's pages; the winner is copied out.
    """

    def __init__(self, inner: BackingStore, *,
                 policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 verify_reads: bool = False,
                 checksum_block: int = 4096,
                 hedge_delay_s: float = 0.0,
                 name: str = "store",
                 seed: Optional[int] = None):
        self.inner = inner
        self.policy = policy if policy is not None else RetryPolicy()
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.verify_reads = bool(verify_reads)
        self.checksum_block = int(checksum_block)
        self.hedge_delay_s = float(hedge_delay_s)
        self.name = name
        self.batch_read_hint = inner.batch_read_hint
        self.batch_write_hint = inner.batch_write_hint
        self._rng = random.Random(seed)
        self._crc: Dict[int, int] = {}
        self._crc_lock = threading.Lock()
        self._c_lock = threading.Lock()
        self._c: Dict[str, int] = {k: 0 for k in _RESILIENCE_COUNTERS}
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()
        self.reset_stats()

    # -- plumbing ------------------------------------------------------------

    @property
    def size(self) -> int:
        return self.inner.size

    def _bump(self, key: str, n: int = 1) -> None:
        with self._c_lock:
            self._c[key] += n

    def resilience_stats(self) -> Dict[str, float]:
        """Lock-coupled counter snapshot + breaker state (scrape-safe: only
        this wrapper's own locks, never the inner store's)."""
        with self._c_lock:
            out: Dict[str, float] = dict(self._c)
        out.update(self.breaker.stats())
        return out

    def _hedge_pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix=f"umap-hedge-{self.name}")
            return self._pool

    def flush(self) -> None:
        self.inner.flush()

    def close(self) -> None:
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        self.inner.close()

    # -- checksums -----------------------------------------------------------

    def _blocks_covered(self, offset: int, length: int):
        """Yield (block_index, start_within_range) for every *full* aligned
        block inside [offset, offset+length); partially covered edge blocks
        are yielded with start None (invalidate-only)."""
        bs = self.checksum_block
        first, last = offset // bs, (offset + length - 1) // bs
        for b in range(first, last + 1):
            lo, hi = b * bs, (b + 1) * bs
            if lo >= offset and hi <= offset + length:
                yield b, lo - offset
            else:
                yield b, None

    def _block_crc(self, bufs: Sequence[np.ndarray], start: int) -> int:
        crc = 0
        for piece in _slice_bufs(bufs, start, self.checksum_block):
            crc = zlib.crc32(piece, crc)
        return crc

    def _note_write(self, offset: int, bufs: Sequence[np.ndarray],
                    length: int) -> None:
        if not self.verify_reads:
            return
        with self._crc_lock:
            for b, start in self._blocks_covered(offset, length):
                if start is None:
                    self._crc.pop(b, None)      # partial write: unknown bytes
                else:
                    self._crc[b] = self._block_crc(bufs, start)

    def _check_read(self, offset: int, bufs: Sequence[np.ndarray],
                    length: int) -> None:
        if not self.verify_reads:
            return
        bad = None
        with self._crc_lock:
            for b, start in self._blocks_covered(offset, length):
                if start is None:
                    continue
                crc = self._block_crc(bufs, start)
                known = self._crc.get(b)
                if known is None:
                    self._crc[b] = crc          # first sighting: record
                elif known != crc:
                    bad = b
                    break
        if bad is not None:
            self._bump("checksum_failures")
            raise CorruptPageError(
                f"{self.name}: CRC mismatch in block {bad} "
                f"(offset {bad * self.checksum_block})")

    # -- the retry loop ------------------------------------------------------

    def _call(self, op: Callable[[], int], *, offset: int,
              bufs: Sequence[np.ndarray], length: int, write: bool) -> int:
        pol = self.policy
        deadline = time.monotonic() + pol.deadline_s
        attempt = 0
        while True:
            if not self.breaker.allow():
                self._bump("breaker_rejections")
                raise BreakerOpenError(f"{self.name}: circuit breaker open")
            try:
                n = op()
                if write:
                    self._note_write(offset, bufs, length)
                else:
                    self._check_read(offset, bufs, length)
                self.breaker.record_success()
                if attempt:
                    self._bump("retries_ok")
                return n
            except BreakerOpenError:
                raise
            except Exception as exc:            # noqa: BLE001 — classified below
                self.breaker.record_failure()
                if not pol.classify(exc):
                    self._bump("permanent_errors")
                    raise
                now = time.monotonic()
                if attempt >= pol.retries:
                    self._bump("exhausted")
                    raise
                sleep = pol.sleep_s(attempt, self._rng)
                if now + sleep >= deadline:
                    self._bump("deadline_exceeded")
                    self._bump("exhausted")
                    raise
                self._bump("retries")
                attempt += 1
                time.sleep(sleep)

    # -- hedged reads --------------------------------------------------------

    def _hedged_read(self, offset: int, bufs: Sequence[np.ndarray],
                     length: int) -> int:
        """One read attempt with a hedge: primary into scratch A; if it has
        not finished within ``hedge_delay_s``, fire an identical read into
        scratch B.  First success wins and is copied into the caller bufs."""
        pool = self._hedge_pool()

        def attempt_into(scratch: np.ndarray) -> Tuple[int, np.ndarray]:
            return self.inner.read_into_batch(offset, [scratch]), scratch

        primary = pool.submit(attempt_into, np.empty(length, np.uint8))
        done, _ = wait([primary], timeout=self.hedge_delay_s)
        futures = [primary]
        if not done:
            self._bump("hedges")
            futures.append(pool.submit(attempt_into,
                                       np.empty(length, np.uint8)))
        first_exc: Optional[BaseException] = None
        pending = set(futures)
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for f in done:
                exc = f.exception()
                if exc is not None:
                    first_exc = first_exc or exc
                    continue
                n, scratch = f.result()
                if f is not primary:
                    self._bump("hedge_wins")
                for dst in _slice_bufs(bufs, 0, length):
                    k = dst.nbytes
                    dst[:] = scratch[:k]
                    scratch = scratch[k:]
                return n
        assert first_exc is not None
        raise first_exc

    # -- BackingStore interface ----------------------------------------------

    def read_into(self, offset: int, buf: np.ndarray) -> int:
        return self.read_into_batch(offset, [buf])

    def write_from(self, offset: int, buf: np.ndarray) -> int:
        return self.write_from_batch(offset, [buf])

    def read_into_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        length = sum(b.nbytes for b in bufs)
        if self.hedge_delay_s > 0:
            op = lambda: self._hedged_read(offset, bufs, length)  # noqa: E731
        else:
            op = lambda: self.inner.read_into_batch(offset, bufs)  # noqa: E731
        n = self._call(op, offset=offset, bufs=bufs, length=length, write=False)
        self._count_read(n)
        return n

    def write_from_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        length = sum(b.nbytes for b in bufs)
        n = self._call(lambda: self.inner.write_from_batch(offset, bufs),
                       offset=offset, bufs=bufs, length=length, write=True)
        self._count_write(n)
        return n

    # -- construction --------------------------------------------------------

    @classmethod
    def from_config(cls, inner: BackingStore, config,
                    name: str = "store") -> "ResilientStore":
        """Build a wrapper from UMapConfig resilience knobs (core/config.py)."""
        pol = RetryPolicy(retries=config.io_retries,
                          backoff_s=config.retry_backoff_s,
                          max_backoff_s=config.retry_max_backoff_s,
                          deadline_s=config.retry_deadline_s)
        br = CircuitBreaker(threshold=config.breaker_threshold,
                            reset_s=config.breaker_reset_s,
                            probes=config.breaker_probes)
        return cls(inner, policy=pol, breaker=br,
                   verify_reads=config.verify_reads,
                   checksum_block=config.page_size,
                   hedge_delay_s=config.hedge_delay_s, name=name)


def wrap_store(store: BackingStore, config) -> BackingStore:
    """Compose resilience into ``store`` per DESIGN.md §17.5.

    A :class:`~repro_torch.core.store.TierChain` is wrapped *per level*, in place
    (every level — ``fast``/``slow`` on the depth-2 facade, each middle
    tier of a deeper chain — gets its own breaker), preserving the chain
    identity the pager keys tier logic on; any other store is wrapped
    whole.  Level names: ``fast`` (level 0), ``slow`` (the base tier),
    ``tier<l>`` (middles).  Idempotent: already-wrapped levels pass
    through.
    """
    from .store import TierChain
    if isinstance(store, TierChain):
        base = store.base_level
        for lvl, s in enumerate(store.levels):
            if isinstance(s, ResilientStore):
                continue
            name = ("fast" if lvl == 0
                    else "slow" if lvl == base else f"tier{lvl}")
            store.set_level(lvl, ResilientStore.from_config(s, config,
                                                            name=name))
        return store
    if isinstance(store, ResilientStore):
        return store
    return ResilientStore.from_config(store, config)


def iter_breakers(store: BackingStore):
    """Yield every CircuitBreaker reachable from ``store`` (tiered stores
    expose one per level).  Duck-typed so callers need no isinstance walls."""
    seen = set()
    levels = getattr(store, "levels", None)
    members = ((store, *levels) if levels is not None else
               (store, getattr(store, "fast", None),
                getattr(store, "slow", None)))
    for s in members:
        br = getattr(s, "breaker", None)
        if isinstance(br, CircuitBreaker) and id(br) not in seen:
            seen.add(id(br))
            yield br


# ---------------------------------------------------------------------------
# ChaosStore
# ---------------------------------------------------------------------------

class ChaosStore(BackingStore):
    """Seeded fault-injection wrapper — the chaos harness (DESIGN.md §17.6).

    Generalizes :class:`~repro_torch.core.store.FaultyStore` from "fail op #N"
    to scripted and probabilistic fault schedules:

      * transient errors  — ``read_error_rate`` / ``write_error_rate``
        fraction of ops raise ``OSError(EIO)`` before touching the inner
        store; of those, ``permanent_fraction`` raise ``PermissionError``
        (permanent) instead.
      * latency spikes    — ``latency_spike_rate`` fraction of ops sleep
        ``latency_spike_s`` before proceeding.
      * torn writes       — ``torn_write_rate`` fraction of writes persist
        only a random prefix of the payload, then raise (transient).
      * bit flips         — ``bit_flip_rate`` fraction of reads flip one
        random bit in the returned bytes after the inner read succeeds
        (silent corruption; caught only by ``verify_reads``).
      * outages           — :meth:`kill` makes every op raise until
        :meth:`revive`; the scripted tier-outage lever for bench_chaos.
      * determinism       — :meth:`fail_next` arms an exact number of
        forced failures for regression tests.

    All draws come from one seeded ``random.Random`` under the store lock,
    so a (seed, op-sequence) pair replays the same schedule.  Injection
    counters (`injected_read_errors`, `torn_writes`, `bit_flips`, ...) let
    tests close the accounting loop against wrapper/pager counters.
    """

    def __init__(self, inner: BackingStore, *, seed: int = 0,
                 read_error_rate: float = 0.0,
                 write_error_rate: float = 0.0,
                 permanent_fraction: float = 0.0,
                 latency_spike_rate: float = 0.0,
                 latency_spike_s: float = 0.05,
                 torn_write_rate: float = 0.0,
                 bit_flip_rate: float = 0.0):
        self.inner = inner
        self.batch_read_hint = inner.batch_read_hint
        self.batch_write_hint = inner.batch_write_hint
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self.read_error_rate = read_error_rate
        self.write_error_rate = write_error_rate
        self.permanent_fraction = permanent_fraction
        self.latency_spike_rate = latency_spike_rate
        self.latency_spike_s = latency_spike_s
        self.torn_write_rate = torn_write_rate
        self.bit_flip_rate = bit_flip_rate
        self._dead = False
        self._forced: List[Tuple[str, bool]] = []   # (kind, permanent)
        self.reads_attempted = 0
        self.writes_attempted = 0
        self.injected_read_errors = 0
        self.injected_write_errors = 0
        self.injected_permanent_errors = 0
        self.outage_rejections = 0
        self.latency_spikes = 0
        self.torn_writes = 0
        self.bit_flips = 0
        self.reset_stats()

    @property
    def size(self) -> int:
        return self.inner.size

    def flush(self) -> None:
        self.inner.flush()

    def close(self) -> None:
        self.inner.close()

    # -- scripted control ----------------------------------------------------

    def kill(self) -> None:
        """Hard outage: every subsequent op raises OSError(EIO) until
        :meth:`revive`."""
        with self._lock:
            self._dead = True

    def revive(self) -> None:
        with self._lock:
            self._dead = False

    @property
    def dead(self) -> bool:
        return self._dead

    def fail_next(self, kind: str, count: int = 1,
                  permanent: bool = False) -> None:
        """Arm ``count`` deterministic failures for the next ``kind`` ops
        (kind in {"read", "write"})."""
        assert kind in ("read", "write")
        with self._lock:
            self._forced.extend((kind, permanent) for _ in range(count))

    # -- injection -----------------------------------------------------------

    def _transient(self, what: str) -> OSError:
        return OSError(_errno.EIO, f"chaos: injected transient {what}")

    def _permanent(self, what: str) -> PermissionError:
        return PermissionError(f"chaos: injected permanent {what}")

    def _pre(self, kind: str) -> float:
        """Pre-op fault draws under the lock; returns a sleep (taken by the
        caller outside the lock) or raises the injected error."""
        with self._lock:
            if kind == "read":
                self.reads_attempted += 1
            else:
                self.writes_attempted += 1
            if self._dead:
                self.outage_rejections += 1
                raise self._transient(f"{kind} during outage")
            for i, (fk, perm) in enumerate(self._forced):
                if fk == kind:
                    del self._forced[i]
                    if perm:
                        self.injected_permanent_errors += 1
                        raise self._permanent(kind)
                    if kind == "read":
                        self.injected_read_errors += 1
                    else:
                        self.injected_write_errors += 1
                    raise self._transient(kind)
            rate = (self.read_error_rate if kind == "read"
                    else self.write_error_rate)
            if rate > 0 and self._rng.random() < rate:
                if (self.permanent_fraction > 0
                        and self._rng.random() < self.permanent_fraction):
                    self.injected_permanent_errors += 1
                    raise self._permanent(kind)
                if kind == "read":
                    self.injected_read_errors += 1
                else:
                    self.injected_write_errors += 1
                raise self._transient(kind)
            sleep = 0.0
            if (self.latency_spike_rate > 0
                    and self._rng.random() < self.latency_spike_rate):
                self.latency_spikes += 1
                sleep = self.latency_spike_s
            return sleep

    def _maybe_flip(self, bufs: Sequence[np.ndarray]) -> None:
        with self._lock:
            if self.bit_flip_rate <= 0 or self._rng.random() >= self.bit_flip_rate:
                return
            total = sum(b.nbytes for b in bufs)
            if total == 0:
                return
            pos = self._rng.randrange(total)
            bit = self._rng.randrange(8)
            self.bit_flips += 1
        for piece in _slice_bufs(bufs, pos, 1):
            piece[0] ^= np.uint8(1 << bit)

    def _maybe_tear(self, offset: int, bufs: Sequence[np.ndarray]) -> None:
        """Torn write: persist a random strict prefix, then raise."""
        with self._lock:
            if (self.torn_write_rate <= 0
                    or self._rng.random() >= self.torn_write_rate):
                return
            total = sum(b.nbytes for b in bufs)
            keep = self._rng.randrange(total) if total else 0
            self.torn_writes += 1
            self.injected_write_errors += 1
        if keep:
            self.inner.write_from_batch(offset, _slice_bufs(bufs, 0, keep))
        raise self._transient("torn write")

    # -- BackingStore interface ----------------------------------------------

    def read_into(self, offset: int, buf: np.ndarray) -> int:
        return self.read_into_batch(offset, [buf])

    def write_from(self, offset: int, buf: np.ndarray) -> int:
        return self.write_from_batch(offset, [buf])

    def read_into_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        sleep = self._pre("read")
        if sleep:
            time.sleep(sleep)
        n = self.inner.read_into_batch(offset, bufs)
        self._maybe_flip(bufs)
        self._count_read(n)
        return n

    def write_from_batch(self, offset: int, bufs: Sequence[np.ndarray]) -> int:
        sleep = self._pre("write")
        if sleep:
            time.sleep(sleep)
        self._maybe_tear(offset, bufs)
        n = self.inner.write_from_batch(offset, bufs)
        self._count_write(n)
        return n

    def chaos_stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "reads_attempted": self.reads_attempted,
                "writes_attempted": self.writes_attempted,
                "injected_read_errors": self.injected_read_errors,
                "injected_write_errors": self.injected_write_errors,
                "injected_permanent_errors": self.injected_permanent_errors,
                "outage_rejections": self.outage_rejections,
                "latency_spikes": self.latency_spikes,
                "torn_writes": self.torn_writes,
                "bit_flips": self.bit_flips,
            }
