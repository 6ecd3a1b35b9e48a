"""Online access-pattern classification — the *automatic* side of §3.6.

The paper argues that page management should adapt to the application's
access pattern, but its mechanism is static: the application declares its
pattern up front (our :class:`~repro_torch.core.hints.AccessAdvice`) and UMap
configures readahead/eviction accordingly.  Follow-on work (eBPF-mm, Nomad)
shows the same knowledge can be *learned online* from the fault stream.  This
module is that learner: a per-region classifier that watches demand-fault
page numbers and detects the phase the region is currently in, so the pager
can retune ``read_ahead`` and the eviction policy mid-run.

Vocabulary (mirrors the advice enum — see :func:`repro_torch.core.hints.advice_for_phase`):

  SEQUENTIAL   monotone unit-stride faults       -> deep readahead, LRU
  STRIDED      dominant constant stride != 1     -> stride-aware readahead
  RANDOM       no dominant delta                 -> no readahead, LRU
  SCAN_REUSE   forward scan that revisits pages  -> deep readahead, SWA
               (cyclic scans: evict-lowest approximates Belady for loops)
  WARMUP       not enough samples yet            -> keep current settings

Precedence rule (documented contract, enforced by the pager):

  **Static hints always win.**  A region whose readahead was pinned — by an
  explicit ``readahead_pages=`` constructor argument or by
  :meth:`UMapRegion.advise` — is never retuned by the classifier.  The
  classifier only drives regions that gave no hint, making it the safe
  default rather than a second authority that can fight the application.

Transitions are damped with hysteresis: a new phase must be observed in
``hysteresis`` consecutive classification rounds (each round = ``interval``
faults) before it is reported, so a handful of stray faults inside a
sequential scan cannot flip the region to RANDOM and back.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from collections import Counter, deque
from typing import Deque, Optional


class Phase(enum.Enum):
    """Detected access phase of a region (classifier output vocabulary)."""

    WARMUP = "warmup"
    SEQUENTIAL = "sequential"
    STRIDED = "strided"
    RANDOM = "random"
    SCAN_REUSE = "scan_reuse"


#: Per-phase (read_ahead, eviction_policy) tuning — the automatic counterpart
#: of :data:`repro_torch.core.hints.ADVICE_SETTINGS`.  STRIDED readahead is applied
#: *along the detected stride* by the pager (pages last + k*stride), which is
#: what a static advice vocabulary cannot express.
PHASE_SETTINGS = {
    Phase.SEQUENTIAL: dict(read_ahead=8, eviction_policy="lru"),
    Phase.STRIDED: dict(read_ahead=4, eviction_policy="lru"),
    Phase.RANDOM: dict(read_ahead=0, eviction_policy="lru"),
    Phase.SCAN_REUSE: dict(read_ahead=16, eviction_policy="swa"),
}


@dataclasses.dataclass(frozen=True)
class PhaseDecision:
    """A confirmed phase transition and the settings the pager should adopt.

    Returned by :meth:`AccessPatternClassifier.observe` exactly once per
    confirmed transition (hysteresis already applied); ``None`` everywhere
    else, so callers can treat any non-None return as "retune now".
    """

    phase: Phase
    stride: int                 # dominant fault stride (1 for SEQUENTIAL)
    read_ahead: int             # pages to keep in flight past a demand fault
    eviction_policy: str        # name understood by buffer.make_policy


class AccessPatternClassifier:
    """Sliding-window phase detector over a region's demand-fault stream.

    Parameters
    ----------
    window:
        Number of recent fault page-numbers retained.  Deltas and reuse are
        computed over this window only, so the classifier tracks *phases*
        rather than whole-run statistics (a sort's sequential merge after a
        random partition pass is detected as SEQUENTIAL, not averaged away).
    min_samples:
        Faults required before leaving WARMUP (avoids classifying noise).
    interval:
        Faults between classification rounds (amortizes the O(window) scan).
    hysteresis:
        Consecutive rounds a *new* phase must win before a transition is
        reported.

    Thread safety: ``observe`` may be called from any faulting thread; state
    is guarded by an internal lock and the hot path is a deque append.
    """

    #: fraction of unit-stride deltas required to call a window SEQUENTIAL
    SEQ_THRESHOLD = 0.70
    #: fraction of the dominant non-unit stride required for STRIDED
    STRIDE_THRESHOLD = 0.60
    #: fraction of revisited pages required for SCAN_REUSE
    REUSE_THRESHOLD = 0.30

    def __init__(self, window: int = 64, min_samples: int = 16,
                 interval: int = 8, hysteresis: int = 2):
        if window < 4:
            raise ValueError("window must be >= 4")
        self.window = window
        self.min_samples = min_samples
        self.interval = max(1, interval)
        self.hysteresis = max(1, hysteresis)
        self._lock = threading.Lock()
        self._pages: Deque[int] = deque(maxlen=window)
        self._seen_recent: Deque[int] = deque(maxlen=4 * window)  # reuse memory
        self._count = 0
        self.phase = Phase.WARMUP
        self.stride = 1
        self._candidate: Optional[Phase] = None
        self._candidate_stride = 1
        self._candidate_rounds = 0
        self.transitions = 0

    # ------------------------------------------------------------------ API

    def observe(self, page_no: int) -> Optional[PhaseDecision]:
        """Feed one demand-fault page number; returns a decision on transition.

        Returns a :class:`PhaseDecision` only when a *new* phase has been
        confirmed for ``hysteresis`` consecutive rounds; otherwise ``None``.
        """
        with self._lock:
            self._pages.append(page_no)
            self._seen_recent.append(page_no)
            self._count += 1
            if (self._count < self.min_samples
                    or self._count % self.interval != 0):
                return None
            return self._classify_locked()

    def snapshot(self) -> dict:
        """Introspection: current phase, stride, and sample count."""
        with self._lock:
            return {
                "phase": self.phase.value,
                "stride": self.stride,
                "samples": self._count,
                "transitions": self.transitions,
            }

    # ------------------------------------------------------------ internals

    def _classify_locked(self) -> Optional[PhaseDecision]:
        pages = list(self._pages)
        # zero deltas (dwelling on one page) are not evidence for or against
        # any phase — drop them so touch-granularity feeds (e.g. per-token KV
        # appends) classify the same as fault-granularity feeds
        deltas = [b - a for a, b in zip(pages, pages[1:]) if b != a]
        if not deltas:
            return None
        n = len(deltas)
        seq = sum(1 for d in deltas if d == 1) / n
        # reuse: fraction of the window's pages that appeared earlier in the
        # (longer) reuse memory — detects a scan wrapping around on itself.
        recent = list(self._seen_recent)[: -len(pages)] if len(
            self._seen_recent) > len(pages) else []
        recent_set = set(recent)
        reuse = (sum(1 for p in pages if p in recent_set) / len(pages)
                 if recent_set else 0.0)
        forward = sum(1 for d in deltas if d >= 0) / n

        if seq >= self.SEQ_THRESHOLD:
            phase = (Phase.SCAN_REUSE
                     if reuse >= self.REUSE_THRESHOLD and forward > 0.8
                     else Phase.SEQUENTIAL)
            stride = 1
        else:
            nonunit = Counter(d for d in deltas if d != 1)
            if nonunit:
                top_stride, top_n = nonunit.most_common(1)[0]
                if top_n / n >= self.STRIDE_THRESHOLD:
                    phase, stride = Phase.STRIDED, int(top_stride)
                else:
                    phase, stride = Phase.RANDOM, 1
            else:
                phase, stride = Phase.RANDOM, 1

        return self._apply_hysteresis_locked(phase, stride)

    def _apply_hysteresis_locked(self, phase: Phase,
                                 stride: int) -> Optional[PhaseDecision]:
        if phase == self.phase and stride == self.stride:
            self._candidate = None
            self._candidate_rounds = 0
            return None
        if phase == self._candidate and stride == self._candidate_stride:
            self._candidate_rounds += 1
        else:
            self._candidate = phase
            self._candidate_stride = stride
            self._candidate_rounds = 1
        if self._candidate_rounds < self.hysteresis:
            return None
        first = self.phase is Phase.WARMUP
        self.phase, self.stride = phase, stride
        self._candidate = None
        self._candidate_rounds = 0
        if not first:
            self.transitions += 1
        cfg = PHASE_SETTINGS[phase]
        return PhaseDecision(phase=phase, stride=stride,
                             read_ahead=cfg["read_ahead"],
                             eviction_policy=cfg["eviction_policy"])
