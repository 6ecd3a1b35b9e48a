"""Dirty-page watermark monitor (paper §3.5 — user-controlled page flushing).

A low-concurrency "manager" thread compares the buffer's dirty ratio against
the user-defined high/low watermarks:

  * dirty ratio >= high  → post write-back batches to the evictor queue
  * dirty ratio <  low   → suspend flushing

This gives applications explicit control over when persistence I/O happens —
the paper's motivation being that kernel-initiated flushing (RHEL: at 10%
dirty) causes jitter and breaks multi-page atomicity expectations.  The same
monitor drives the asynchronous checkpoint flusher in ``repro_torch.ckpt``.

Since the sharded refactor (DESIGN.md §12) this monitor is the *backpressure
driver* of the decoupled write path: all watermark write-back flows through
the service's dedicated cleaner queue (``submit_clean_batch``), which is the
only path that writes — fillers never do.  Dirty accounting is read
lock-free (per-shard ``dirty_count`` ints are GIL-consistent); a slightly
stale ratio only shifts a flush batch by one poll interval.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from .pager import PagingService


class WatermarkMonitor:
    def __init__(self, service: "PagingService", poll_interval_s: float = 0.005):
        self.service = service
        self.poll_interval_s = poll_interval_s
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="umap-watermark", daemon=True
        )
        self.flushing = False   # between high and low watermark

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5.0)

    def poke(self) -> None:
        """Hint that dirty state changed (called on writes)."""
        self._wake.set()

    def _run(self) -> None:
        cfg = self.service.config
        while not self._stop.is_set():
            self._wake.wait(timeout=self.poll_interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            ratio = self.service.dirty_ratio()
            if not self.flushing and ratio >= cfg.evict_high_water:
                self.flushing = True
            if self.flushing:
                if ratio < cfg.evict_low_water:
                    self.flushing = False     # suspend (low watermark)
                    continue
                # Flush down toward the low watermark in bounded batches so
                # evictors stay busy without monopolizing the queue.
                target_dirty = int(cfg.evict_low_water * self.service.buffer.num_slots)
                excess = self.service.table.dirty_count - target_dirty
                if excess > 0:
                    self.service.submit_clean_batch(excess)
