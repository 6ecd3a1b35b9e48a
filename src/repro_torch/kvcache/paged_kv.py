"""Paged KV cache: the device-side UMap region (port of ``repro/kvcache/paged_kv.py``).

Layout (per decoder layer-stack):

  k_pool / v_pool : [L, num_pages, page_size, KVH, D]   the UMap buffer
  page tables     : host-side, per sequence (allocator.py free list)

``page_size`` (tokens per page) is the paper's §3.6 knob.  The attention
read path goes through ``kernels/paged_attention`` (block-table indirection
in-kernel); installs, copy-on-write copies and ``lease_kv`` go through
``kernels/page_gather`` (UFFDIO_COPY analogue), one launch per pool for
every layer.  A contiguous, max-length pre-allocated cache
(:class:`ContiguousKVCache`) is the mmap baseline this design is compared
against.

Unlike the JAX package, pool updates are **in-place** tensor writes (JAX
rebuilt the pool with ``.at[].set``); they stay under the metadata lock so
a writer's page allocation and its device write are one step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device, torch_dtype
from ..core.pattern import AccessPatternClassifier, Phase
from ..kernels.page_gather.ops import page_gather, page_scatter, pool_rows, token_rows
from ..kernels.paged_attention.ops import paged_attention
from .allocator import OutOfPages, PageAllocator


class KVBlockLease:
    """Zero-copy K/V block views for one sequence (DESIGN.md §13).

    ``k``/``v`` are device tensors gathered straight from the pool through
    the sequence's block table (one ``page_gather`` per pool).  While the
    lease is live the sequence is pinned: ``release()`` (sequence free) and
    window-prefix eviction are refused/deferred.
    """

    __slots__ = ("_cache", "seq_id", "pages", "k", "v", "_released")

    def __init__(self, cache: "PagedKVCache", seq_id: int, pages: List[int],
                 k: torch.Tensor, v: torch.Tensor):
        self._cache = cache
        self.seq_id = seq_id
        self.pages = pages
        self.k = k
        self.v = v
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._cache._unpin_seq(self.seq_id)

    def __enter__(self) -> "KVBlockLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


@dataclasses.dataclass
class PagedKVConfig:
    num_layers: int
    num_kv_heads: int
    head_dim: int
    page_size: int = 64          # tokens per page (UMAP_PAGESIZE analogue)
    num_pages: int = 1024        # pool pages per layer (UMAP_BUFSIZE analogue)
    max_pages_per_seq: int = 128
    dtype: str = "bfloat16"
    # --- adaptive engine opt-in (DESIGN.md §8) ------------------------------
    # Per-sequence page-touch streams feed an online classifier; with an
    # attention_window set, page-prefix eviction fires automatically once a
    # sequence's phase is confirmed SEQUENTIAL.
    adaptive: bool = False
    attention_window: Optional[int] = None   # tokens (sliding-window models)

    @property
    def page_bytes(self) -> int:
        return (self.page_size * self.num_kv_heads * self.head_dim
                * 2 * torch_dtype(self.dtype).itemsize)


class PagedKVCache:
    """Host-managed page tables over device-resident pools.

    Host-side metadata (allocator free list, per-sequence lengths, dropped
    prefixes, classifiers) and the in-place pool writes are guarded by one
    lock; contended acquisitions are counted
    (``stats()["host_lock_contended"]``).  Callers must not interleave
    ``append_token`` for the SAME sequence from two threads (per-sequence
    ordering is the engine's contract).
    """

    def __init__(self, cfg: PagedKVConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        shape = (cfg.num_layers, cfg.num_pages, cfg.page_size,
                 cfg.num_kv_heads, cfg.head_dim)
        dt = torch_dtype(cfg.dtype)
        self.k_pool = torch.zeros(shape, dtype=dt, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dt, device=self.device)
        self.allocator = PageAllocator(cfg.num_pages)
        self.seq_len: Dict[int, int] = {}
        # pages dropped off the front of each sequence by window eviction —
        # logical page index = physical index into pages_of() + dropped
        self.pages_dropped: Dict[int, int] = {}
        self._classifiers: Dict[int, AccessPatternClassifier] = {}
        self.auto_evicted_pages = 0
        self._meta_lock = threading.Lock()
        self._meta_contended = 0
        self._seq_pins: Dict[int, int] = {}
        self._lease_count = 0
        self._lease_blocked_evictions = 0

    @contextlib.contextmanager
    def _locked_meta(self):
        """Acquire the host-metadata lock, counting contended acquisitions."""
        if not self._meta_lock.acquire(blocking=False):
            self._meta_lock.acquire()
            self._meta_contended += 1
        try:
            yield
        finally:
            self._meta_lock.release()

    def _ids(self, pages: List[int]) -> torch.Tensor:
        return torch.tensor(pages, dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------- sequences

    def add_sequence(self, seq_id: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Install a prefilled sequence.  k/v: [L, S, KVH, D]."""
        S = k.shape[1]
        n_pages = -(-S // self.cfg.page_size)
        dt = self.k_pool.dtype
        kr = token_rows(k.to(self.device, dt))
        vr = token_rows(v.to(self.device, dt))
        with self._locked_meta():
            pages = self.allocator.alloc(seq_id, n_pages)
            idx = self._ids(pages)
            # one layered scatter per pool; the last page's tail is zeros
            page_scatter(pool_rows(self.k_pool), idx, kr)
            page_scatter(pool_rows(self.v_pool), idx, vr)
            self.seq_len[seq_id] = S

    def share_prefix(self, src_seq: int, dst_seq: int, tokens: int) -> int:
        """Map ``src_seq``'s first ``tokens`` positions into ``dst_seq``
        copy-on-write (prompt-prefix sharing, DESIGN.md §16.4).

        Only whole pages are shared (``tokens`` is rounded DOWN to a page
        multiple).  Returns the number of positions actually shared.  The
        first :meth:`append_token` landing in a shared page copies it.
        """
        ps = self.cfg.page_size
        with self._locked_meta():
            if self.pages_dropped.get(src_seq, 0):
                raise ValueError(
                    "cannot share from a window-evicted sequence: its page "
                    "list no longer starts at logical page 0")
            n_pages = min(tokens, self.seq_len.get(src_seq, 0)) // ps
            if n_pages <= 0:
                return 0
            self.allocator.share(src_seq, dst_seq, n_pages)
            self.seq_len[dst_seq] = n_pages * ps
            return n_pages * ps

    def _cow_for_write(self, seq_id: int, page_idx: int) -> int:
        """Give ``seq_id`` a private copy of its ``page_idx``-th page before
        a write lands in it; returns the (possibly new) physical page.
        Caller holds the metadata lock."""
        res = self.allocator.make_private(seq_id, page_idx)
        if res is not None:
            ids = self._ids(list(res))
            for pool in (self.k_pool, self.v_pool):
                rows = pool_rows(pool)
                page_scatter(rows, ids[1:], page_gather(rows, ids[:1]))
        return self.allocator.pages_of(seq_id)[page_idx]

    def append_token(self, seq_id: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Append one token.  k/v: [L, KVH, D].  Allocates a page on boundary;
        copies a shared page (COW) before the first divergent write."""
        ps = self.cfg.page_size
        dt = self.k_pool.dtype
        with self._locked_meta():
            pos = self.seq_len[seq_id]
            if pos % ps == 0:
                self.allocator.alloc(seq_id, 1)
            idx = pos // ps - self.pages_dropped.get(seq_id, 0)
            if self.allocator.is_shared(seq_id, idx):
                page = self._cow_for_write(seq_id, idx)
            else:
                page = self.allocator.pages_of(seq_id)[idx]
            slot = pos % ps
            self.k_pool[:, page, slot] = k.to(self.device, dt)
            self.v_pool[:, page, slot] = v.to(self.device, dt)
            self.seq_len[seq_id] = pos + 1
        if pos % ps == 0:               # observe at page granularity
            self._observe(seq_id, pos // ps)    # outside the lock: may evict

    def _observe(self, seq_id: int, page_idx: int) -> None:
        """Adaptive opt-in: feed the sequence's page-touch stream (DESIGN.md §8).

        A confirmed SEQUENTIAL phase on a sliding-window model triggers
        automatic prefix eviction.
        """
        if not self.cfg.adaptive:
            return
        with self._locked_meta():
            clf = self._classifiers.get(seq_id)
            if clf is None:
                clf = self._classifiers[seq_id] = AccessPatternClassifier(
                    window=16, min_samples=4, interval=2, hysteresis=2)
        clf.observe(page_idx)
        if (self.cfg.attention_window is not None
                and clf.phase is Phase.SEQUENTIAL):
            freed = self.evict_window_prefix(seq_id, self.cfg.attention_window)
            if freed:
                with self._locked_meta():   # += is a read-modify-write
                    self.auto_evicted_pages += len(freed)

    def detected_phase(self, seq_id: int) -> Optional[str]:
        """Telemetry: the classifier's phase for one sequence (None if off)."""
        clf = self._classifiers.get(seq_id)
        return None if clf is None else clf.snapshot()["phase"]

    def release(self, seq_id: int) -> int:
        with self._locked_meta():
            if self._seq_pins.get(seq_id, 0) > 0:
                raise RuntimeError(
                    f"sequence {seq_id} has live KV leases; release the "
                    f"leases before freeing the sequence")
            self.seq_len.pop(seq_id, None)
            self.pages_dropped.pop(seq_id, None)
            self._classifiers.pop(seq_id, None)
            return self.allocator.free_seq(seq_id)

    # ---------------------------------------------- zero-copy leases (§13)

    def lease_kv(self, seq_id: int,
                 layer: Optional[int] = None) -> KVBlockLease:
        """Lease the sequence's K/V blocks as gathered device tensors.

        One ``page_gather`` launch per pool: for one layer over the layer's
        pool viewed as [P, page_size*KVH*D], result [n, page_size, KVH, D];
        for ``layer=None`` over every layer ([L, n, page_size, KVH, D]), as
        in the JAX package.  The sequence is pinned against
        free/window-eviction until release.
        """
        with self._locked_meta():
            pages = list(self.allocator.pages_of(seq_id))
            self._seq_pins[seq_id] = self._seq_pins.get(seq_id, 0) + 1
            self._lease_count += 1
        idx = self._ids(pages)
        if layer is None:
            shape = self.k_pool.shape[:1] + (len(pages),) + self.k_pool.shape[2:]
            k = page_gather(pool_rows(self.k_pool), idx).view(shape)
            v = page_gather(pool_rows(self.v_pool), idx).view(shape)
        else:
            shape = (len(pages),) + tuple(self.k_pool.shape[2:])
            P = self.cfg.num_pages
            k = page_gather(self.k_pool[layer].view(P, -1), idx).view(shape)
            v = page_gather(self.v_pool[layer].view(P, -1), idx).view(shape)
        return KVBlockLease(self, seq_id, pages, k, v)

    def _unpin_seq(self, seq_id: int) -> None:
        with self._locked_meta():
            n = self._seq_pins.get(seq_id, 0) - 1
            if n <= 0:
                self._seq_pins.pop(seq_id, None)
            else:
                self._seq_pins[seq_id] = n

    def evict_window_prefix(self, seq_id: int, window: int) -> List[int]:
        """Sliding-window policy: free pages fully behind the window.

        Refused (empty result + ``lease_blocked_evictions``) while the
        sequence holds live KV leases."""
        ps = self.cfg.page_size
        with self._locked_meta():
            if self._seq_pins.get(seq_id, 0) > 0:
                self._lease_blocked_evictions += 1
                return []
            keep_from = max(0, self.seq_len.get(seq_id, 0) - window)
            dropped = self.pages_dropped.get(seq_id, 0)
            evictable = keep_from // ps - dropped
            if evictable <= 0:
                return []
            freed = self.allocator.free_prefix(seq_id, evictable)
            self.pages_dropped[seq_id] = dropped + len(freed)
            return freed

    # ------------------------------------------------------------- attention

    def batch_tables(self, seq_ids: List[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Page-table rows keyed by *logical* page index (int32 tensors on
        the cache's device): token ``t`` of a sequence resolves through
        ``row[t // page_size]``, so rows of window-evicted sequences lead
        with ``pages_dropped`` fill entries."""
        mp = self.cfg.max_pages_per_seq
        rows = []
        with self._locked_meta():   # consistent rows vs concurrent evict/append
            for s in seq_ids:
                d = self.pages_dropped.get(s, 0)
                pages = self.allocator.pages_of(s)
                row = np.zeros(mp, np.int32)
                row[d : d + len(pages)] = pages[: max(0, mp - d)]
                rows.append(row)
            lengths = [self.seq_len.get(s, 0) for s in seq_ids]
        return (torch.from_numpy(np.stack(rows)).to(self.device),
                torch.tensor(lengths, dtype=torch.int32, device=self.device))

    def attend(self, layer: int, q: torch.Tensor, seq_ids: List[int],
               impl: str = "auto") -> torch.Tensor:
        """Decode attention for one layer.  q: [B, H, D] (B == len(seq_ids))."""
        table, lengths = self.batch_tables(seq_ids)
        return paged_attention(q, self.k_pool[layer], self.v_pool[layer],
                               table, lengths, impl=impl)

    # ------------------------------------------------------------- telemetry

    def stats(self) -> dict:
        with self._locked_meta():   # _classifiers/seq_len mutate concurrently
            return {
                "pages_used": self.allocator.used_pages,
                "pages_free": self.allocator.free_pages,
                "occupancy": self.allocator.occupancy(),
                "page_bytes": self.cfg.page_bytes,
                "sequences": len(self.seq_len),
                "cow_copies": self.allocator.cow_copies,
                "shared_pages": self.allocator.shared_pages(),
                "shared_pages_mapped": self.allocator.shared_mapped,
                "auto_evicted_pages": self.auto_evicted_pages,
                "host_lock_contended": self._meta_contended,
                "leases": self._lease_count,
                "lease_blocked_evictions": self._lease_blocked_evictions,
                "leased_sequences": sum(1 for n in self._seq_pins.values()
                                        if n > 0),
                "phases": {s: c.snapshot()["phase"]
                           for s, c in self._classifiers.items()},
            }

    def register_telemetry(self, registry=None, label=None) -> List[str]:
        """Opt this cache into the telemetry registry (DESIGN.md §15).

        Registers a serve collector (occupancy, eviction, phase-mix
        gauges) and a lease collector (KV lease counters); returns their
        registry names.  Scrapes go through :meth:`stats`, which takes
        the host metadata lock — the documented scrape-path exception
        (§15.3): that lock is never held across store I/O or device work,
        only across dict reads, so a scrape can stall a metadata update
        by nanoseconds but can never block a fill or a decode step.
        """
        from ..telemetry import default_registry
        from ..telemetry.collectors import LeaseCollector, ServeCollector
        reg = registry if registry is not None else default_registry()
        return [reg.register(ServeCollector(kv=self, label=label)),
                reg.register(LeaseCollector(kv=self, label=label))]


class ContiguousKVCache:
    """The mmap baseline: per-sequence max-length pre-allocation.

    Same interface as PagedKVCache for the benchmark comparison; memory is
    reserved up front per slot (internal fragmentation = max_len - actual).
    """

    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int,
                 max_seqs: int, max_len: int, dtype: str = "bfloat16",
                 device="cuda"):
        self.device = resolve_device(device)
        self.k = torch.zeros((num_layers, max_seqs, max_len, num_kv_heads, head_dim),
                             dtype=torch_dtype(dtype), device=self.device)
        self.v = torch.zeros_like(self.k)
        self.max_len = max_len
        self.slots: Dict[int, int] = {}
        self._free = list(range(max_seqs - 1, -1, -1))
        self.seq_len: Dict[int, int] = {}

    def add_sequence(self, seq_id: int, k: torch.Tensor, v: torch.Tensor) -> None:
        if not self._free:
            raise OutOfPages("no contiguous slots left")
        slot = self._free.pop()
        self.slots[seq_id] = slot
        S = k.shape[1]
        self.k[:, slot, :S] = k.to(self.device, self.k.dtype)
        self.v[:, slot, :S] = v.to(self.device, self.v.dtype)
        self.seq_len[seq_id] = S

    def append_token(self, seq_id: int, k: torch.Tensor, v: torch.Tensor) -> None:
        slot = self.slots[seq_id]
        pos = self.seq_len[seq_id]
        self.k[:, slot, pos] = k.to(self.device, self.k.dtype)
        self.v[:, slot, pos] = v.to(self.device, self.v.dtype)
        self.seq_len[seq_id] = pos + 1

    def release(self, seq_id: int) -> int:
        slot = self.slots.pop(seq_id)
        self._free.append(slot)
        self.seq_len.pop(seq_id, None)
        return self.max_len

    def reserved_tokens(self) -> int:
        return len(self.slots) * self.max_len

    def used_tokens(self) -> int:
        return sum(self.seq_len.values())
