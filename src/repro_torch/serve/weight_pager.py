"""Layer-weight pager: UMap regions over *model weights* (host -> card).
Port of ``repro/serve/weight_pager.py``.

For models whose parameters exceed device memory (or to free device memory
for KV), per-layer weight trees live in host memory (the backing store) and
page into a fixed ring of device slots (the UMap buffer).  The access
pattern is known (layer i+1 follows layer i), so the pager is purely
anticipatory: ``readahead`` layers are always in flight — the paper's §2
adaptation (reactive faults -> anticipatory fills, DESIGN.md §2).

With ``adaptive=True`` the pager opts into the online classifier
(core/pattern.py, DESIGN.md §8): layer indices feed an
AccessPatternClassifier, and the readahead depth follows the detected phase
— deep for the usual forward sweep, zero when the request stream turns
random (e.g. speculative-decode layer skipping) so slots are not wasted on
layers that will not be used.

``host_layers`` may be a plain list of trees (numpy arrays or CPU tensors)
or a :class:`RegionLayerSource` — the zero-copy route (DESIGN.md §13) where
layer bytes live behind a UMap region and each fetch pins the layer's
pages with ``region.lease_run``, copies the lease views host -> device by
address (no staging memcpy, the views stay read-only), installs them into
a device page pool with ``page_scatter`` and assembles the layer with
``page_gather`` (the CUDA kernels of ``csrc/page_gather.cu`` on the card).

Filler concurrency mirrors the sharded core (DESIGN.md §12): ``num_fillers``
worker threads, each with its OWN deque + condition and its own CUDA
stream, route transfers by layer index; an idle filler steals from the
busiest peer, so a burst of prefetches for far-apart layers overlaps
host->device copies.  The default of one filler preserves strictly ordered
installs for the streaming case.  What JAX ordered by data dependence is
ordered here by events: ``get`` makes the caller's stream wait on an event
recorded after the fill, and the pool's copies finish before its lock is
released (see :meth:`RegionLayerSource.__getitem__`).

On a CPU ``device`` every copy is a plain host copy and nothing waits.
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device, torch_dtype
from ..core.pattern import AccessPatternClassifier
from ..interop import tree_flatten, tree_map
from ..kernels.page_gather.kernel import copy_h2d
from ..kernels.page_gather.ops import page_gather, page_scatter

PyTree = Any


def pack_layer_arrays(arrays: Sequence[np.ndarray],
                      page_size: int) -> Tuple[np.ndarray, List[dict]]:
    """Pack per-layer arrays page-aligned into one flat byte buffer.

    Returns ``(buf, specs)`` where ``buf`` is the byte image to back a
    UMap store (``HostArrayStore(buf)`` / written to a ``FileStore``) and
    ``specs[i]`` records layer ``i``'s shape/dtype/page extent for
    :class:`RegionLayerSource`.  Every layer starts on a page boundary and
    is zero-padded to a whole number of pages, so lease views are always
    full aligned pages (the zero-staging-copy case, DESIGN.md §13).
    """
    dtype = np.dtype(arrays[0].dtype)
    if any(np.dtype(a.dtype) != dtype for a in arrays):
        raise ValueError("pack_layer_arrays requires a uniform dtype")
    if page_size % dtype.itemsize:
        raise ValueError(
            f"page_size {page_size} not a multiple of itemsize {dtype.itemsize}")
    specs: List[dict] = []
    chunks: List[np.ndarray] = []
    page = 0
    for a in arrays:
        flat = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
        npages = -(-flat.nbytes // page_size)
        pad = npages * page_size - flat.nbytes
        chunks.append(flat)
        if pad:
            chunks.append(np.zeros(pad, np.uint8))
        specs.append({"shape": tuple(a.shape), "dtype": str(dtype),
                      "first_page": page, "npages": npages})
        page += npages
    return np.concatenate(chunks), specs


def _copy_in(row: torch.Tensor, page: np.ndarray) -> None:
    """Copy one host page into the uint8 ``row`` of a device tensor.  On
    the card by address (``copy_h2d``, on the current stream): a read-lease
    view is read-only, and wrapping it in a tensor would warn about that."""
    if not page.flags.c_contiguous:
        raise ValueError("a page to copy must be contiguous")
    if row.is_cuda:
        copy_h2d(row, page.ctypes.data, page.nbytes)
    else:
        row.numpy()[:page.nbytes] = page.view(np.uint8).reshape(-1)


def _landed(device: torch.device) -> None:
    """Wait until the work enqueued so far on this thread's current stream
    has run (an event recorded now, synchronised); nothing on the CPU."""
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        ev.synchronize()


class RegionLayerSource:
    """Host layers behind a UMap region, assembled on the card by page_gather.

    Drop-in for ``LayerWeightPager``'s ``host_layers`` sequence: item ``i``
    is layer ``i``'s device tensor.  The fetch path is the zero-copy route
    (DESIGN.md §13): ``region.lease_run`` pins the layer's pages and each
    lease view — an alias of the page buffer, no staging memcpy — is copied
    host -> device into one row of a ``[npages, page_elems]`` device tensor;
    the rows are scattered into a device-side page pool (``page_scatter``)
    and the layer is assembled through block-table indirection
    (``page_gather``).  Leases are released only after the host->device
    copies have landed, so eviction cannot recycle a buffer slot
    mid-transfer.

    The region's buffer must be able to pin a whole layer at once
    (``lease_run`` caps runs at half the buffer); the device pool holds
    ``pool_pages`` pages (default: enough for every layer) evicted
    layer-at-a-time FIFO.

    The pool's dtype is ``dtype`` (default: the specs' dtype).  numpy has
    no bf16 of its own, so bf16 weights packed as their ``uint16`` bit
    patterns (``interop.to_numpy``) take ``dtype=torch.bfloat16``: the pool
    holds the same bytes, viewed as bf16, and the plain copies on the CPU
    take it (they do not take ``uint16``).

    ``pin_fast_layers`` is the tiered-store opt-in (DESIGN.md §14.3): when
    the region's store is a ``TieredStore`` (host fast tier over an
    NVMe/remote weight file), the named layers' page ranges are advised
    ``tier_hint="pin_fast"`` so they stay fast-tier resident under any
    migration pressure — e.g. the embedding layer and final head, which
    every request touches regardless of the streaming sweep.
    """

    def __init__(self, region, specs: Sequence[dict], device="cuda",
                 pool_pages: Optional[int] = None,
                 pin_fast_layers: Sequence[int] = (), dtype=None):
        self.region = region
        self.specs = list(specs)
        if pin_fast_layers:
            if not getattr(region, "tiered", False):
                raise ValueError(
                    "pin_fast_layers requires a TieredStore-backed region")
            ps = region.page_size
            for i in pin_fast_layers:
                spec = self.specs[i]
                region.advise(tier_hint="pin_fast",
                              offset=spec["first_page"] * ps,
                              nbytes=spec["npages"] * ps)
        self.device = resolve_device(device)
        if len({s["dtype"] for s in self.specs}) != 1:
            raise ValueError("RegionLayerSource requires a uniform dtype")
        packed = torch_dtype(self.specs[0]["dtype"])
        self.dtype = packed if dtype is None else torch_dtype(dtype)
        if self.dtype.itemsize != packed.itemsize:
            raise ValueError(f"pool dtype {self.dtype} does not have the item size "
                             f"of the packed {packed}")
        self.page_elems = region.page_size // self.dtype.itemsize
        need = max(s["npages"] for s in self.specs)
        self.pool_pages = (sum(s["npages"] for s in self.specs)
                           if pool_pages is None else pool_pages)
        if self.pool_pages < need:
            raise ValueError(
                f"pool_pages {self.pool_pages} cannot hold the largest "
                f"layer ({need} pages)")
        self._pool = torch.zeros((self.pool_pages, self.page_elems),
                                 dtype=self.dtype, device=self.device)
        self._layer_slots: Dict[int, List[int]] = {}   # layer -> pool slots
        self._fifo: List[int] = []                     # layer install order
        self._free = list(range(self.pool_pages - 1, -1, -1))
        self._lock = threading.Lock()
        # Layers whose host fetch + H2D transfer is in flight: the lock is
        # NOT held across the transfer (that would serialize the weight
        # pager's filler pool); duplicate fetchers wait on the event.
        self._inflight: Dict[int, threading.Event] = {}
        self.staging_copies = 0     # non-lease fallback fetches (telemetry)

    def __len__(self) -> int:
        return len(self.specs)

    def register_telemetry(self, registry=None, label=None) -> str:
        """Opt this source into the telemetry registry (DESIGN.md §15):
        a lease collector exposing the staging-copy counter (nonzero only
        on the copy-backed fallback path).  Returns the registry name."""
        from ..telemetry import default_registry
        from ..telemetry.collectors import LeaseCollector
        reg = registry if registry is not None else default_registry()
        return reg.register(LeaseCollector(weight_source=self, label=label))

    def _take_slots(self, n: int) -> List[int]:
        """Pop ``n`` pool slots, evicting oldest layers (lock held)."""
        while len(self._free) < n:
            victim = self._fifo.pop(0)
            self._free.extend(self._layer_slots.pop(victim))
        return [self._free.pop() for _ in range(n)]

    def invalidate(self, layers: Optional[Sequence[int]] = None) -> None:
        """Drop cached device pages for ``layers`` (default: all).

        The device pool caches layer bytes as fetched from the region;
        a writer that mutates the region afterwards (the OOC trainer's
        parameter sweep, DESIGN.md §18.2) must invalidate so the next
        ``__getitem__`` re-fetches fresh bytes.  In-flight fetches are
        not interrupted — callers sequence invalidation after their own
        fetch/update barrier, as the trainer's step loop does.
        """
        with self._lock:
            victims = (list(self._layer_slots)
                       if layers is None else
                       [i for i in layers if i in self._layer_slots])
            for i in victims:
                self._free.extend(self._layer_slots.pop(i))
                self._fifo.remove(i)

    def _fetch_pages(self, spec: dict) -> torch.Tensor:
        """The layer's pages as a device ``[npages, page_elems]`` tensor —
        zero host staging via leases."""
        n, ps = spec["npages"], self.region.page_size
        staged = torch.empty((n, self.page_elems), dtype=self.dtype, device=self.device)
        rows = staged.view(torch.uint8)
        if self.region.service.config.zero_copy_leases:
            with self.region.lease_run(spec["first_page"], n) as run:
                for row, view in zip(rows, run.views):
                    _copy_in(row, view)
                # the copies read the leased buffer slots: the slots must
                # stay pinned until the copies have landed
                _landed(self.device)
            return staged
        # Copy-backed fallback (UMAP_ZERO_COPY_LEASES=0): one staging
        # memcpy per page through region.read.
        self.staging_copies += n
        pages = [self.region.read((spec["first_page"] + j) * ps, ps) for j in range(n)]
        for row, page in zip(rows, pages):
            _copy_in(row, page)
        _landed(self.device)        # before the staging buffers are freed
        return staged

    def _ids(self, slots: List[int]) -> torch.Tensor:
        return torch.tensor(slots, dtype=torch.int32, device=self.device)

    def __getitem__(self, i: int) -> torch.Tensor:
        spec = self.specs[i]
        while True:
            owner = False
            with self._lock:
                slots = self._layer_slots.get(i)
                if slots is not None:
                    # Gather under the lock AND run it to completion there:
                    # page_scatter writes the pool in place, on whichever
                    # filler's stream installs next, so a gather still
                    # *executing* when another stream scatters into these
                    # slots would read half-overwritten pages — order
                    # under the lock is dispatch order, not execution.
                    flat = page_gather(self._pool, self._ids(slots))
                    _landed(self.device)
                    break
                ev = self._inflight.get(i)
                if ev is None:                # this thread fetches
                    ev = self._inflight[i] = threading.Event()
                    owner = True
            if owner:
                try:
                    # Lease + H2D transfer with NO lock held — concurrent
                    # fillers fetching other layers genuinely overlap.
                    staged = self._fetch_pages(spec)
                    with self._lock:
                        slots = self._take_slots(spec["npages"])
                        page_scatter(self._pool, self._ids(slots), staged)
                        # complete before publishing: the next gather of
                        # these slots, or the next install into them once
                        # evicted, may run on another filler's stream
                        _landed(self.device)
                        self._layer_slots[i] = slots
                        self._fifo.append(i)
                finally:
                    with self._lock:
                        self._inflight.pop(i, None)
                    ev.set()
            else:
                ev.wait(timeout=0.05)
            # loop re-checks _layer_slots: covers publish, fetch failure
            # (waiters become the next owner), and eviction races
        nelems = int(np.prod(spec["shape"])) if spec["shape"] else 1
        return flat.reshape(-1)[:nelems].reshape(spec["shape"])


def _host_tensor(a) -> torch.Tensor:
    """A host leaf (numpy array, bf16 included, or tensor) as a tensor,
    without a copy where it is already contiguous."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class LayerWeightPager:
    def __init__(self, host_layers: List[PyTree], num_slots: int = 4,
                 readahead: int = 2, device="cuda", adaptive: bool = False,
                 num_fillers: int = 1):
        assert num_slots >= readahead + 1
        assert num_fillers >= 1
        self.host_layers = host_layers
        self.num_layers = len(host_layers)
        self.num_slots = num_slots
        self.readahead = readahead
        self.device = resolve_device(device)
        # layer -> (device tree, event recorded after its fill or None)
        self._slots: Dict[int, Tuple[PyTree, Optional[torch.cuda.Event]]] = {}
        self._order: List[int] = []                  # FIFO residency (stream)
        self._events: Dict[int, threading.Event] = {}
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None   # a filler's failure
        self._classifier = (AccessPatternClassifier(
            window=16, min_samples=4, interval=2, hysteresis=2)
            if adaptive else None)
        self.stats = {"fills": 0, "hits": 0, "waits": 0, "evictions": 0,
                      "pattern_transitions": 0, "steals": 0}
        # Per-filler deques + stealing (the core's §3.3 protocol in
        # miniature): each deque has its own condition — no global queue
        # lock.  Never hold two deque conditions at once.
        self._qs: List[deque] = [deque() for _ in range(num_fillers)]
        self._cvs: List[threading.Condition] = [
            threading.Condition() for _ in range(num_fillers)]
        # each filler copies on its own stream (the reference's device_put)
        self._streams = [torch.cuda.Stream(self.device) if self.device.type == "cuda"
                         else None for _ in range(num_fillers)]
        self._shutdown = False
        self._fillers = [
            threading.Thread(target=self._fill_loop, args=(i,), daemon=True,
                             name=f"weight-pager-filler-{i}")
            for i in range(num_fillers)
        ]
        for t in self._fillers:
            t.start()

    def register_telemetry(self, registry=None, label=None) -> str:
        """Opt this pager into the telemetry registry (DESIGN.md §15).

        Returns the registry name of the serve collector.  The collector
        reads the plain-dict ``stats`` counters without ``_lock`` —
        GIL-atomic int reads, same relaxed contract as the core pager's
        snapshot — so a scrape never contends with fills or evictions.
        """
        from ..telemetry import default_registry
        from ..telemetry.collectors import ServeCollector
        reg = registry if registry is not None else default_registry()
        return reg.register(ServeCollector(weight_pager=self, label=label))

    # ------------------------------------------------------------- pager

    def _steal(self, worker_id: int) -> bool:
        victim = -1
        victim_len = 0
        for i, q in enumerate(self._qs):
            if i != worker_id and len(q) > victim_len:
                victim, victim_len = i, len(q)
        if victim < 0:
            return False
        stolen: List[int] = []
        with self._cvs[victim]:
            vq = self._qs[victim]
            for _ in range(max(1, len(vq) // 2)):
                if not vq:
                    break
                stolen.append(vq.pop())
        if not stolen:
            return False
        stolen.reverse()
        with self._cvs[worker_id]:
            self._qs[worker_id].extend(stolen)
        with self._lock:
            self.stats["steals"] += 1
        return True

    def _fill(self, layer: int, stream) -> Tuple[PyTree, Optional[torch.cuda.Event]]:
        """Layer ``layer`` on the device, copied on ``stream``, and an event
        recorded after the copies (None on the CPU)."""
        with (torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()):
            tree = tree_map(lambda a: _host_tensor(a).to(self.device, non_blocking=True),
                            self.host_layers[layer])
            if stream is None:
                return tree, None
            ready = torch.cuda.Event()
            ready.record(stream)
            return tree, ready

    def _fill_loop(self, worker_id: int) -> None:
        dq = self._qs[worker_id]
        cv = self._cvs[worker_id]
        idle_wait = 0.01       # steal-rescan backoff, as in the core pager
        while True:
            layer: Optional[int] = None
            while layer is None:
                with cv:
                    if not dq and not self._shutdown:
                        cv.wait(timeout=idle_wait)
                    if dq:
                        layer = dq.popleft()
                if layer is None:
                    if self._steal(worker_id):
                        idle_wait = 0.01
                        continue
                    if self._shutdown:
                        return
                    idle_wait = min(idle_wait * 2, 0.5)
                else:
                    idle_wait = 0.01
            with self._lock:
                if layer in self._slots or layer in self._events and \
                        self._events[layer].is_set():
                    continue
                ev = self._events.setdefault(layer, threading.Event())
            try:
                entry = self._fill(layer, self._streams[worker_id])
            except Exception as exc:     # reported to every get(), not lost
                with self._lock:
                    self._error = exc
                ev.set()
                return
            with self._lock:
                self._slots[layer] = entry
                self._order.append(layer)
                self.stats["fills"] += 1
                while len(self._slots) > self.num_slots:
                    victim = self._order.pop(0)       # forward stream: FIFO/SWA
                    self._slots.pop(victim, None)
                    self._events.pop(victim, None)
                    self.stats["evictions"] += 1
                ev.set()

    def prefetch(self, layer: int) -> None:
        if 0 <= layer < self.num_layers:
            with self._lock:
                if layer in self._slots or layer in self._events:
                    return
                self._events[layer] = threading.Event()
            route = layer % len(self._qs)
            with self._cvs[route]:
                self._qs[route].append(layer)
                self._cvs[route].notify()

    def _use_here(self, entry) -> PyTree:
        """The filled tree, ordered before the caller's current stream: the
        stream waits on the fill's event, and every tensor is marked as in
        use there, so the allocator does not hand its memory to a filler's
        stream while this stream may still read it."""
        tree, ready = entry
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in tree_flatten(tree)[0]:
                if isinstance(t, torch.Tensor):
                    t.record_stream(stream)
        return tree

    def get(self, layer: int) -> PyTree:
        """Block until layer resident; issues readahead for the next layers."""
        if not 0 <= layer < self.num_layers:
            # prefetch() silently ignores out-of-range layers, so without
            # this the retry loop below would spin forever
            raise IndexError(f"layer {layer} out of range [0, {self.num_layers})")
        if self._classifier is not None:
            d = self._classifier.observe(layer)
            if d is not None:
                # clamp to the slot ring; slots must cover readahead + 1
                self.readahead = max(0, min(self.num_slots - 1, d.read_ahead))
                self.stats["pattern_transitions"] += 1
        for ahead in range(1, self.readahead + 1):
            self.prefetch(layer + ahead)
        # Re-check after every wake: with num_fillers > 1 the layer can be
        # installed AND evicted (out-of-order installs overflowing the ring)
        # between the filler's event set and this thread being scheduled,
        # so a single wait-then-index would KeyError.
        waited = False
        while True:
            with self._lock:
                entry = self._slots.get(layer)
                ev = self._events.get(layer)
                error = self._error
            if error is not None:
                raise RuntimeError(f"weight pager: a filler failed: {error!r}") from error
            if entry is not None:
                self.stats["waits" if waited else "hits"] += 1
                return self._use_here(entry)
            if ev is None:                 # never requested, or evicted: retry
                self.prefetch(layer)
            else:
                waited = True
                ev.wait(timeout=0.05)

    def run(self, x, apply_fn: Callable[[PyTree, Any, int], Any]):
        """Stream x through all layers: apply_fn(layer_params, x, i)."""
        self.prefetch(0)
        for i in range(self.num_layers):
            x = apply_fn(self.get(i), x, i)
        return x

    def close(self) -> None:
        self._shutdown = True
        for cv in self._cvs:
            with cv:
                cv.notify_all()
        for t in self._fillers:
            t.join(timeout=5)
