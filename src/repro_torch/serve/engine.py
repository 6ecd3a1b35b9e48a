"""Multi-tenant serving engine: continuous batching over a shared KV pool.

All tenants share ONE paged device pool (the UMap buffer); the engine is the
paper's application-hints thesis applied to serving (DESIGN.md §16):

  * host side   — refcounted page allocation (kvcache/allocator: free list +
                  copy-on-write prefix sharing), per-tenant fair-share
                  watermarks (the §3.5 occupancy gate made tenant-relative,
                  weighted by tenant priority), SLO-aware admission ordering
                  (deadline headroom, not binary occupancy), tenant-weighted
                  victim selection under pool pressure, straggler requeue
                  with bounded restarts;
  * device side — one ``decode_step`` over the paged caches ({k_pool,
                  v_pool, table, len} per attention segment) whose attention
                  reads the pool through the page table in the
                  ``paged_attention`` CUDA kernel, and a bucketed ``prefill``
                  whose KV lands in pool pages through the ``page_scatter``
                  kernel, one launch per pool for all of a segment's layers
                  (a copy-on-write adds a ``page_gather`` per pool).  Pools
                  are updated in place (the JAX package rebuilt them
                  functionally).

Port of ``repro/serve/engine.py``: the host-side scheduling is the same
logic line for line; the device side is eager PyTorch on ``device``
(default ``"cuda"``).  Decode batches are fixed-width (max_batch) with
empty lanes masked (they write to and read from scratch page 0) — the
continuous batching pattern.

Prefix sharing: ``register_prefix`` prefills a common prompt prefix once
into pool pages owned by a pseudo-sequence; requests whose prompt starts
with that prefix map those pages into their own page table (refcount++)
instead of allocating copies.  Shared pages are copied lazily on the first
divergent write (prefill tail spilling into the boundary page, or a decode
step writing into a shared page) — the COW lifecycle in DESIGN.md §16.4.
Priority tenants additionally pin their prefix bytes into the fast tier of
an optional ``prefix_region`` through the existing ``tier_hint``/
``pin_fast`` machinery (§14.3).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device, torch_dtype
from ..configs.base import ModelConfig
from ..core.hints import deadline_headroom_s, fair_shares
from ..interop import tree_map
from ..kernels.page_gather.ops import page_gather, page_scatter, pool_rows, token_rows
from ..kvcache.allocator import OutOfPages, PageAllocator
from ..models import transformer as T
from ..models.blocks import block_cache_init


@dataclasses.dataclass
class Tenant:
    """One tenant sharing the pool.  ``weight`` sets the fair-share page
    budget; ``priority`` orders admission and inverts victim selection
    (higher priority = admitted first, evicted last); ``pin_fast`` pins the
    tenant's registered prefixes into the prefix region's tier chain, at
    level ``pin_level`` (0 = fastest; mid-priority tenants can claim a
    middle level of a deeper chain without competing for the fastest)."""

    name: str
    weight: float = 1.0
    priority: int = 0
    pin_fast: bool = False
    pin_level: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int = 16
    deadline_s: Optional[float] = None  # straggler mitigation + SLO target
    tenant: str = "default"
    submitted_at: float = dataclasses.field(default_factory=time.time)
    generated: List[int] = dataclasses.field(default_factory=list)
    restarts: int = 0
    # set by the engine:
    first_submitted_at: Optional[float] = None
    admitted_at: Optional[float] = None
    finished_at: Optional[float] = None
    slo_miss: bool = False              # finished after its deadline
    expired: bool = False               # gave up after max_restarts
    prefill_ms: float = 0.0             # time of its prefills (see _mark)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def latency_s(self) -> Optional[float]:
        if self.finished_at is None or self.first_submitted_at is None:
            return None
        return self.finished_at - self.first_submitted_at


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    page_size: int = 16                 # tokens/page — the UMap knob
    num_pages: int = 512                # pool size per layer (UMAP_BUFSIZE)
    max_pages_per_seq: int = 64
    prefill_bucket: int = 64            # prompts padded to this length
    admit_high_water: float = 0.85      # stop admitting (paper §3.5 analogue)
    admit_low_water: float = 0.60       # resume admitting
    # --- multi-tenant serving (DESIGN.md §16) ------------------------------
    prefix_sharing: bool = True         # COW prompt-prefix page sharing
    slo_admission: bool = True          # order admission by deadline headroom
    slo_safety: float = 1.25            # est. service time margin
    est_step_s: float = 5e-3            # EWMA seeds (replaced by measurement)
    est_prefill_s: float = 20e-3
    max_restarts: int = 8               # requeue bound before a request expires
    # --- degraded-mode admission (DESIGN.md §17.9) -------------------------
    # While the paging service reports an open circuit breaker, service-time
    # estimates are scaled by degrade_multiplier (degraded paging stretches
    # every fill) and — with degrade_shed — deadline requests that cannot
    # meet their SLO under the scaled estimate are shed at admission instead
    # of admitted only to time out holding a lane.
    degrade_multiplier: float = 3.0
    degrade_shed: bool = True


@dataclasses.dataclass
class PrefixEntry:
    """A registered shared prompt prefix living in pool pages."""

    key: Tuple[int, ...]                # the prefix token ids
    seq_id: int                         # owning pseudo-sequence (< -1)
    tenant: str
    n_tokens: int                       # KV positions held (P + meta tokens)
    pages: List[int]
    pinned: bool
    hits: int = 0
    last_used: float = 0.0


_TENANT_KEYS = ("prefills", "evictions", "requeues", "admission_pauses",
                "slo_deferrals", "slo_misses", "expired", "finished",
                "tokens_generated", "shed_requests")


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: dict, ecfg: EngineConfig,
                 prefix_region=None, paging_service=None, device="cuda"):
        assert not cfg.is_encdec and cfg.input_mode == "tokens", \
            "engine demo targets decoder-only token models"
        self.cfg = cfg
        self.device = resolve_device(device)
        # cast once to the compute dtype: the per-step cast is then a no-op
        self.params = tree_map(lambda t: t.to(self.device),
                               T.cast_params(cfg, params))
        self.ecfg = ecfg
        self.plan = cfg.decoder_plan()
        self.allocator = PageAllocator(ecfg.num_pages)
        # page 0 is the scratch page: idle lanes (zeroed tables) write their
        # dummy tokens there, never into a live sequence's pages
        self._scratch_page = self.allocator.alloc(-1, 1)[0]
        assert self._scratch_page == 0
        self.waiting: List[Request] = []
        self.active: Dict[int, Request] = {}
        self.lane_of: Dict[int, int] = {}
        self.finished: List[Request] = []
        self._free_lanes = list(range(ecfg.max_batch - 1, -1, -1))
        self._admission_paused = False
        self.seq_len: Dict[int, int] = {}
        # tenants share the pool; fair shares follow from their weights
        self.tenants: Dict[str, Tenant] = {"default": Tenant("default")}
        self._tenant_paused: Dict[str, bool] = {}
        self._prefixes: Dict[Tuple[int, ...], PrefixEntry] = {}
        self._next_prefix_seq = -2          # -1 is the scratch pseudo-seq
        self.prefix_region = prefix_region  # optional UMapRegion (tier pins)
        # Degraded-state source (DESIGN.md §17.9): an explicit paging
        # service, else the prefix region's — duck-typed; None disables.
        self._paging_service = (paging_service if paging_service is not None
                                else getattr(prefix_region, "service", None))
        self._region_cursor = 0
        self._est_step_s = ecfg.est_step_s
        self._est_prefill_s = ecfg.est_prefill_s
        self.stats = {"steps": 0, "prefills": 0, "evictions": 0,
                      "requeues": 0, "admission_pauses": 0,
                      "slo_deferrals": 0, "slo_misses": 0, "expired": 0,
                      "shed_requests": 0,
                      "victim_evictions": 0, "cow_copies": 0,
                      "shared_pages_mapped": 0, "prefix_hits": 0,
                      "prefix_drops": 0, "peak_pages_used": 0,
                      "per_tenant": {}}
        self._caches = self._init_caches()
        self._pending_prefills: list = []   # (request, start mark, end mark)

    def register_telemetry(self, registry=None, label=None) -> str:
        """Opt this engine into the telemetry registry (DESIGN.md §15).

        Returns the registry name of the serve collector.  The collector
        reads the engine's plain-dict counters and queue lengths only —
        no engine lock exists, and a scrape never touches device state.
        """
        from ..telemetry import default_registry
        from ..telemetry.collectors import ServeCollector
        reg = registry if registry is not None else default_registry()
        return reg.register(ServeCollector(engine=self, label=label))

    # -------------------------------------------------------------- tenants

    def add_tenant(self, tenant: Tenant) -> Tenant:
        self.tenants[tenant.name] = tenant
        self._tstats(tenant.name)
        return tenant

    def _tenant(self, name: str) -> Tenant:
        t = self.tenants.get(name)
        if t is None:
            t = self.add_tenant(Tenant(name))
        return t

    def _tstats(self, name: str) -> dict:
        per = self.stats["per_tenant"]
        if name not in per:
            per[name] = {k: 0 for k in _TENANT_KEYS}
        return per[name]

    def _fair_share_pages(self) -> Dict[str, int]:
        # scratch page excluded from the shareable budget
        return fair_shares({n: t.weight for n, t in self.tenants.items()},
                           self.ecfg.num_pages - 1)

    def _tenant_pages(self, name: str) -> int:
        """Pages charged to a tenant: private pages of its live sequences
        plus the pages of prefixes it registered.  Shared pages are charged
        to the registering tenant only (no double counting)."""
        n = 0
        for rid, req in self.active.items():
            if req.tenant == name:
                n += sum(1 for p in self.allocator.pages_of(rid)
                         if self.allocator.refcount(p) == 1)
        for entry in self._prefixes.values():
            if entry.tenant == name:
                n += len(entry.pages)
        return n

    # --------------------------------------------------------------- caches

    def _init_caches(self) -> list:
        """Per attention segment: the page pools [count, P, ps, KVH, D] and
        the table/len rows every layer of the segment reads (one [B, ...]
        tensor expanded over the layer axis, rewritten each step); a hymba
        segment adds its lanes' Mamba state, ``ssm`` [count, B, d_inner, N]
        fp32 and ``conv`` [count, B, d_conv - 1, d_inner].  A purely
        recurrent segment (mLSTM, sLSTM) holds per-lane state only, fp32
        state and the compute dtype's ``conv`` (``block_cache_init``); the
        allocator still books its pages, as the JAX engine does, and no
        pool reads them."""
        e = self.ecfg
        dt = torch_dtype(self.cfg.compute_dtype)
        dev = self.device
        caches = []
        for seg in self.plan:
            if not seg.has_attention:
                caches.append(_stacked(block_cache_init(self.cfg, seg, e.max_batch, 8,
                                                        dt, dev), seg.count))
                continue
            shape = (seg.count, e.num_pages, e.page_size,
                     self.cfg.num_kv_heads, self.cfg.head_dim)
            c = {
                "k_pool": torch.zeros(shape, dtype=dt, device=dev),
                "v_pool": torch.zeros(shape, dtype=dt, device=dev),
                "table": torch.zeros((e.max_batch, e.max_pages_per_seq),
                                     dtype=torch.int32, device=dev
                                     ).expand(seg.count, -1, -1),
                "len": torch.zeros(e.max_batch, dtype=torch.int32,
                                   device=dev).expand(seg.count, -1),
            }
            if seg.has_mamba:
                mc = block_cache_init(self.cfg, seg, e.max_batch, 8, dt, dev)
                c.update(_stacked({k: mc[k] for k in ("ssm", "conv")}, seg.count))
            caches.append(c)
        return caches

    # ------------------------------------------------------- prefix sharing

    def register_prefix(self, tokens, tenant: str = "default"
                        ) -> Tuple[int, ...]:
        """Prefill a shared prompt prefix once into pool pages.

        Requests whose prompt starts with ``tokens`` map these pages
        copy-on-write instead of allocating their own.  Returns the prefix
        key (the token tuple).  Raises :class:`OutOfPages` when the pool
        cannot hold the prefix even after reclaiming idle prefixes.
        """
        tokens = np.asarray(tokens, np.int32)
        key = tuple(int(t) for t in tokens)
        if key in self._prefixes:
            return key
        t = self._tenant(tenant)
        e = self.ecfg
        P = len(tokens)
        eff = P + self.cfg.num_meta_tokens
        n_pages = -(-eff // e.page_size)
        if self.allocator.free_pages < n_pages and \
                not self._reclaim(n_pages):
            raise OutOfPages(
                f"prefix of {n_pages} pages does not fit "
                f"({self.allocator.free_pages} free)")
        cache = self._run_prefill(tokens)        # KV for ALL prefix tokens
        seq_id = self._next_prefix_seq
        self._next_prefix_seq -= 1
        pages = self.allocator.alloc(seq_id, n_pages)
        for i, (seg, c) in enumerate(zip(self.plan, self._caches)):
            if not seg.has_attention:
                continue
            k = cache[i]["k"][:, 0, :eff]
            v = cache[i]["v"][:, 0, :eff]
            self._caches[i] = _install_pages(c, k, v, pages, e.page_size)
        entry = PrefixEntry(key=key, seq_id=seq_id, tenant=tenant,
                            n_tokens=eff, pages=pages, pinned=t.pin_fast,
                            last_used=time.time())
        self._prefixes[key] = entry
        self._persist_prefix(tokens, entry)
        self._note_pool()
        return key

    def drop_prefix(self, key: Tuple[int, ...]) -> int:
        """Unregister a prefix; pages still shared by live sequences survive
        until those sequences release them (refcounted)."""
        entry = self._prefixes.pop(tuple(key))
        released = self.allocator.free_seq(entry.seq_id)
        self.stats["prefix_drops"] += 1
        return released

    def _match_prefix(self, prompt: np.ndarray) -> Optional[PrefixEntry]:
        if not self.ecfg.prefix_sharing or not self._prefixes:
            return None
        pt = tuple(int(x) for x in prompt)
        best = None
        for key, entry in self._prefixes.items():
            if len(key) <= len(pt) and pt[: len(key)] == key:
                if best is None or len(key) > len(best.key):
                    best = entry
        return best

    def _persist_prefix(self, tokens: np.ndarray, entry: PrefixEntry) -> None:
        """Stash prefix tokens in the optional backing region and pin a
        priority tenant's bytes into the fast tier (§14.3 hint path)."""
        if self.prefix_region is None:
            return
        data = np.frombuffer(tokens.tobytes(), np.uint8)
        off = self._region_cursor
        if off + len(data) > self.prefix_region.size:
            return
        self.prefix_region.write(off, data)
        self._region_cursor = off + len(data)
        if getattr(self.prefix_region, "tiered", False):
            if entry.pinned:
                t = self.tenants.get(entry.tenant)
                lvl = getattr(t, "pin_level", 0) if t is not None else 0
                hint = f"pin_fast:{lvl}" if lvl > 0 else "pin_fast"
            else:
                hint = "hot"
            self.prefix_region.advise(tier_hint=hint, offset=off,
                                      nbytes=len(data))

    # ------------------------------------------------------------ admission

    def submit(self, req: Request) -> None:
        if req.first_submitted_at is None:
            req.first_submitted_at = req.submitted_at
        self._tenant(req.tenant)
        self.waiting.append(req)

    def _watermark_gate(self) -> bool:
        """UMap §3.5 watermarks on pool occupancy gate admission (global
        backstop; the per-tenant fair-share gate runs underneath it)."""
        occ = self.allocator.occupancy()
        if self._admission_paused:
            if occ < self.ecfg.admit_low_water:
                self._admission_paused = False
        elif occ >= self.ecfg.admit_high_water:
            self._admission_paused = True
            self.stats["admission_pauses"] += 1
        return not self._admission_paused

    def _tenant_gate(self, name: str) -> bool:
        """Fair-share watermark per tenant: pause a tenant's admission when
        its page consumption crosses ``admit_high_water`` of its fair share,
        resume below ``admit_low_water`` (same hysteresis as §3.5, budget
        relative to the tenant's weight)."""
        e = self.ecfg
        share = max(1, self._fair_share_pages().get(name, 1))
        occ = self._tenant_pages(name) / share
        paused = self._tenant_paused.get(name, False)
        if paused:
            if occ < e.admit_low_water:
                self._tenant_paused[name] = False
                paused = False
        elif occ >= e.admit_high_water:
            self._tenant_paused[name] = True
            paused = True
            self.stats["admission_pauses"] += 1
            self._tstats(name)["admission_pauses"] += 1
        return not paused

    def paging_degraded(self) -> bool:
        """True while the paging service backing this engine reports an
        open circuit breaker (DESIGN.md §17.9).  Duck-typed + defensive:
        the degradation probe must never take the engine down."""
        svc = self._paging_service
        if svc is None:
            return False
        try:
            return svc.open_breakers() > 0
        except Exception:       # noqa: BLE001 — health probe is best-effort
            return False

    def _service_est_s(self, req: Request, degraded: bool) -> float:
        est = self._est_prefill_s + req.max_new_tokens * self._est_step_s
        if degraded:
            est *= self.ecfg.degrade_multiplier
        return est

    def _slo_defer(self, req: Request, now: float,
                   degraded: bool = False) -> bool:
        """Deadline-headroom admission (not binary occupancy): defer a
        request whose estimated service time exceeds its remaining budget
        while feasible work waits.  Requests whose deadline already passed
        are NOT deferred (nothing is saved) and requests are never starved:
        the relaxed admission pass admits deferred requests into idle lanes.
        While the paging service is degraded, estimates carry the
        degradation multiplier — circuit-open paging stretches every fill.
        """
        if not self.ecfg.slo_admission or req.deadline_s is None:
            return False
        head = deadline_headroom_s(req.deadline_s, req.submitted_at, now)
        if head <= 0:
            return False
        return self._service_est_s(req, degraded) * self.ecfg.slo_safety > head

    def _admit_key(self, now: float):
        def key(req: Request):
            t = self._tenant(req.tenant)
            return (-t.priority,
                    deadline_headroom_s(req.deadline_s, req.submitted_at, now),
                    req.first_submitted_at or req.submitted_at, req.rid)
        return key

    def _pages_needed(self, req: Request) -> int:
        S = len(req.prompt)
        return -(-(S + self.cfg.num_meta_tokens) // self.ecfg.page_size) + 1

    def _try_admit(self) -> None:
        """Admit waiting requests in SLO order: tenant priority first, then
        deadline headroom (tightest feasible first), then arrival.  Pass 1
        skips SLO-infeasible requests; pass 2 relaxes that so idle lanes are
        never wasted and no request starves."""
        now = time.time()
        degraded = self.paging_degraded()
        remaining = self.waiting
        # reclaim during admission can evict+requeue a live victim, which
        # appends to self.waiting — keep that list separate so the victim
        # is not lost when the un-admitted remainder is written back
        self.waiting = []
        for relax_slo in (False, True):
            if not remaining or not self._free_lanes:
                break
            keep: List[Request] = []
            for req in sorted(remaining, key=self._admit_key(now)):
                if (degraded and self.ecfg.degrade_shed
                        and req.deadline_s is not None
                        and self._service_est_s(req, degraded)
                        * self.ecfg.slo_safety
                        > deadline_headroom_s(req.deadline_s,
                                              req.submitted_at, now)):
                    # Degraded paging: a request that cannot meet its SLO
                    # under the scaled estimate is shed now, not admitted
                    # to a lane it would hold until it times out.
                    self._shed(req, now)
                    continue
                if not self._free_lanes or not self._watermark_gate() \
                        or not self._tenant_gate(req.tenant):
                    keep.append(req)
                    continue
                if not relax_slo and self._slo_defer(req, now, degraded):
                    self.stats["slo_deferrals"] += 1
                    self._tstats(req.tenant)["slo_deferrals"] += 1
                    keep.append(req)
                    continue
                need = self._pages_needed(req)
                # admission may reclaim idle prefixes freely but may only
                # evict LIVE victims of strictly lower tenant priority —
                # evicting an equal-priority in-flight request to admit a
                # fresh one would livelock two requests swapping the pool
                if self.allocator.free_pages < need and not self._reclaim(
                        need,
                        max_victim_priority=self._tenant(req.tenant).priority):
                    keep.append(req)
                    continue
                self._prefill_into_pool(req)
            remaining = keep
        self.waiting = remaining + self.waiting

    # -------------------------------------------------------------- prefill

    def _run_prefill(self, prompt: np.ndarray) -> list:
        """Bucketed prefill of a token array; returns the contiguous cache.

        Recurrent segments (mamba/mlstm/slstm) carry state, so right-padding
        would corrupt it — those archs prefill at exact length; pure-attention
        archs pad to the compile bucket (causality makes padding harmless).

        The cache keeps every prefilled position of every attention
        segment, a windowed one too: its pages must hold each position the
        install reads (``[:, 0, a0:eff]``), and ``paged_attention`` applies
        the window at decode.  (The JAX package prefills into
        ``init_cache``'s ring of ``window`` slots and installs that ring as
        if it held positions in order, which past the window puts the wrong
        keys in the pages; ROADMAP.md, divergences of the reference.)
        """
        e = self.ecfg
        S = len(prompt)
        has_recurrent = any(seg.has_mamba or not seg.has_attention
                            for seg in self.plan)
        if has_recurrent or S == 0:
            bucket = max(S, 1)
        else:
            bucket = max(e.prefill_bucket,
                         -(-S // e.prefill_bucket) * e.prefill_bucket)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :S] = prompt
        dt = torch_dtype(self.cfg.compute_dtype)
        cache = [_stacked(block_cache_init(self.cfg, dataclasses.replace(seg, window=None), 1,
                                           bucket + 8 + self.cfg.num_meta_tokens, dt,
                                           self.device), seg.count)
                 for seg in self.plan]
        _, cache = T.prefill(self.cfg, self.params,
                             {"tokens": torch.from_numpy(tokens).to(self.device)},
                             cache)
        return cache

    def _prefill_into_pool(self, req: Request) -> None:
        """Prefill prompt[:-1] into pool pages; the last prompt token is fed
        as the first decode step (standard prefill/decode split).

        With a matching registered prefix, the page-aligned shared span is
        *mapped* (refcount++) instead of allocated; only the tail past the
        shared tokens is installed, COW-copying the boundary page when the
        tail writes into it (DESIGN.md §16.4).
        """
        t0 = time.perf_counter()
        start = self._mark()
        e = self.ecfg
        ps = e.page_size
        prompt = req.prompt[:-1]
        S = len(prompt)
        cache = self._run_prefill(prompt)
        lane = self._free_lanes.pop()
        eff = S + self.cfg.num_meta_tokens
        eff_final = eff + 1                     # incl. pending last token
        need_total = -(-eff_final // ps) + 1

        entry = self._match_prefix(req.prompt)
        n_shared = 0
        shared_tok = 0
        if entry is not None:
            shared_tok = min(entry.n_tokens, eff)
            n_shared = min(-(-shared_tok // ps) if shared_tok else 0,
                           len(entry.pages), need_total)
            if n_shared:
                self.allocator.share(entry.seq_id, req.rid, n_shared)
                entry.hits += 1
                entry.last_used = time.time()
                self.stats["prefix_hits"] += 1
                self.stats["shared_pages_mapped"] = self.allocator.shared_mapped
        tail = need_total - n_shared
        if tail > 0:
            self.allocator.alloc(req.rid, tail)

        # install start: first page this request must write itself
        if n_shared and shared_tok % ps and eff > shared_tok:
            # prefill tail spills into the shared boundary page: first
            # divergent write → COW now.  No device copy needed — the whole
            # page is rewritten below from this request's own prefill (the
            # shared span re-derives bit-identically; positions past eff in
            # the page are masked by `len`).
            self.allocator.make_private(req.rid, n_shared - 1)
            self.stats["cow_copies"] = self.allocator.cow_copies
            a0 = (n_shared - 1) * ps
        else:
            a0 = n_shared * ps
        pages = self.allocator.pages_of(req.rid)

        for i, (seg, c) in enumerate(zip(self.plan, self._caches)):
            if not seg.has_attention:
                # recurrent caches: copy prefilled state into the lane
                self._caches[i] = _copy_state_lane(c, cache[i], lane)
                continue
            # move prefilled contiguous KV into pool pages for this lane
            k = cache[i]["k"][:, 0, a0:eff]
            v = cache[i]["v"][:, 0, a0:eff]
            self._caches[i] = _install_pages(
                c, k, v, pages[a0 // ps:], ps, lane=lane,
                prior_state=cache[i] if seg.has_mamba else None)
        self.active[req.rid] = req
        self.lane_of[req.rid] = lane
        self.seq_len[req.rid] = eff
        req.admitted_at = time.time()
        self.stats["prefills"] += 1
        self._tstats(req.tenant)["prefills"] += 1
        self._note_pool()
        self._pending_prefills.append((req, start, self._mark()))
        dt = time.perf_counter() - t0
        self._est_prefill_s = 0.8 * self._est_prefill_s + 0.2 * dt

    def _mark(self):
        """A point in the device's work: a recorded CUDA event on the card
        (no synchronisation), the host clock on the CPU."""
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _settle_prefill_times(self, wait: bool = False) -> None:
        """Add each finished prefill's time (prefill and page install) to
        its request's ``prefill_ms``: device time between its events on the
        card, host time on the CPU.  With ``wait``, waits for the device."""
        pending = []
        for req, start, end in self._pending_prefills:
            if isinstance(end, float):
                req.prefill_ms += (end - start) * 1e3
            elif wait or end.query():
                end.synchronize()
                req.prefill_ms += start.elapsed_time(end)
            else:
                pending.append((req, start, end))
        self._pending_prefills = pending

    # --------------------------------------------------------------- decode

    def step(self) -> int:
        """One engine iteration: admit, decode the active set, retire."""
        t0 = time.perf_counter()
        self._try_admit()
        if not self.active:
            return 0
        e = self.ecfg
        ps = e.page_size
        now = time.time()
        live: List[int] = []
        for rid, req in list(self.active.items()):
            # straggler mitigation: requeue requests past their deadline
            if req.deadline_s and now - req.submitted_at > req.deadline_s:
                self._evict(rid, requeue=True)
                continue
            live.append(rid)

        # Host-side page work for lanes about to write a page: boundary
        # allocation (reclaiming from over-share tenants on pressure) and
        # COW of shared pages.  `live` is rebuilt, never mutated mid-scan
        # (a victim eviction may remove ANY rid, including ones already
        # passed), so no lane's allocation is silently skipped.
        survivors: List[int] = []
        for rid in live:
            if rid not in self.active:      # evicted as an earlier victim
                continue
            pos = self.seq_len[rid]
            if pos % ps == 0 and not self._alloc_decode_page(rid):
                continue                     # rid was evicted + requeued
            if not self._ensure_private(rid, pos // ps):
                continue
            survivors.append(rid)
        live = [r for r in survivors if r in self.active]
        if not live:
            return 0

        tokens = np.zeros(e.max_batch, np.int32)
        cur = np.zeros(e.max_batch, np.int32)
        for rid in live:
            req = self.active[rid]
            lane = self.lane_of[rid]
            tokens[lane] = req.generated[-1] if req.generated \
                else int(req.prompt[-1])
            cur[lane] = self.seq_len[rid]
        self._sync_tables(live)

        logits, self._caches = T.decode_step(
            self.cfg, self.params, self._caches,
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(cur).to(self.device))
        next_tokens = logits.argmax(dim=-1).cpu().numpy()
        self._settle_prefill_times()            # the copy above synchronised
        for rid in live:
            lane = self.lane_of[rid]
            req = self.active[rid]
            req.generated.append(int(next_tokens[lane]))
            self.seq_len[rid] += 1
            if req.done:
                self._retire(rid)
        self.stats["steps"] += 1
        self._note_pool()
        dt = time.perf_counter() - t0
        self._est_step_s = 0.8 * self._est_step_s + 0.2 * dt
        return len(live)

    def _alloc_decode_page(self, rid: int) -> bool:
        """Boundary page for a decoding sequence; on pool exhaustion evict
        tenant-weighted victims, falling back to requeueing ``rid`` itself."""
        try:
            self.allocator.alloc(rid, 1)
            return True
        except OutOfPages:
            pass
        if self._reclaim(1, exclude_rid=rid):
            try:
                self.allocator.alloc(rid, 1)
                return True
            except OutOfPages:     # pragma: no cover - reclaim raced
                pass
        self._evict(rid, requeue=True)
        return False

    def _ensure_private(self, rid: int, page_idx: int) -> bool:
        """COW before a decode write lands in a shared page."""
        if not self.allocator.is_shared(rid, page_idx):
            return True
        try:
            res = self.allocator.make_private(rid, page_idx)
        except OutOfPages:
            if not self._reclaim(1, exclude_rid=rid):
                self._evict(rid, requeue=True)
                return False
            res = self.allocator.make_private(rid, page_idx)
        if res is not None:
            ids = torch.tensor(res, dtype=torch.int32, device=self.device)
            for seg, c in zip(self.plan, self._caches):
                if seg.has_attention:
                    _copy_page(c, ids)
        self.stats["cow_copies"] = self.allocator.cow_copies
        return True

    def _sync_tables(self, live: List[int]) -> None:
        e = self.ecfg
        table = np.zeros((e.max_batch, e.max_pages_per_seq), np.int32)
        lens = np.zeros(e.max_batch, np.int32)
        for rid in live:
            lane = self.lane_of[rid]
            table[lane] = self.allocator.table_for(rid, e.max_pages_per_seq)
            lens[lane] = self.seq_len[rid]
        tj = torch.from_numpy(table).to(self.device)
        lj = torch.from_numpy(lens).to(self.device)
        for i, (seg, c) in enumerate(zip(self.plan, self._caches)):
            if seg.has_attention:
                c = dict(c)
                c["table"] = tj.expand(c["table"].shape)
                c["len"] = lj.expand(c["len"].shape)
                self._caches[i] = c

    # ------------------------------------------------------------- eviction

    def _reclaim(self, need: int, exclude_rid: Optional[int] = None,
                 max_victim_priority: Optional[int] = None) -> bool:
        """Free pages under pressure, cheapest reversal first (§16.5):
        idle unpinned prefixes (LRU), then live sequences — lowest tenant
        priority first, most-over-fair-share tenant first, least progress
        first — and pinned prefixes only as the last resort.

        ``max_victim_priority`` (admission path) restricts live victims to
        tenants of strictly lower priority; the decode path passes None and
        may evict any live sequence to keep the batch progressing."""
        alloc = self.allocator
        if alloc.free_pages >= need:
            return True
        for pinned_pass in (False, True):
            for key in sorted(
                    [k for k, en in self._prefixes.items()
                     if en.pinned == pinned_pass],
                    key=lambda k: self._prefixes[k].last_used):
                self.drop_prefix(key)
                if alloc.free_pages >= need:
                    return True
            if pinned_pass:
                break
            shares = self._fair_share_pages()
            used = {n: self._tenant_pages(n) for n in self.tenants}

            def victim_key(rid: int):
                req = self.active[rid]
                t = self._tenant(req.tenant)
                over = used[req.tenant] / max(1, shares.get(req.tenant, 1))
                return (t.priority, -over, len(req.generated), rid)

            victims = [
                r for r in self.active
                if r != exclude_rid and (
                    max_victim_priority is None
                    or self._tenant(self.active[r].tenant).priority
                    < max_victim_priority)]
            for rid in sorted(victims, key=victim_key):
                self._evict(rid, requeue=True)
                self.stats["victim_evictions"] += 1
                if alloc.free_pages >= need:
                    return True
        return alloc.free_pages >= need

    def _evict(self, rid: int, requeue: bool) -> None:
        """uunmap analogue: free all pages + lane; optionally requeue.
        Restarts are bounded: past ``max_restarts`` the request expires
        (retired with ``expired=True``) instead of looping forever."""
        self.allocator.free_seq(rid)
        lane = self.lane_of.pop(rid)
        self._free_lanes.append(lane)
        req = self.active.pop(rid)
        self.seq_len.pop(rid, None)
        self.stats["evictions"] += 1
        self._tstats(req.tenant)["evictions"] += 1
        if not requeue:
            return
        if req.restarts >= self.ecfg.max_restarts:
            req.expired = True
            self.stats["expired"] += 1
            self._tstats(req.tenant)["expired"] += 1
            self._finish(req)
            return
        req.restarts += 1
        req.generated = []           # restart decodes from the prompt:
        req.submitted_at = time.time()   # greedy decode re-derives the same
        self.waiting.append(req)         # tokens, so restarts stay byte-safe
        self.stats["requeues"] += 1
        self._tstats(req.tenant)["requeues"] += 1

    def _retire(self, rid: int) -> None:
        self.allocator.free_seq(rid)
        lane = self.lane_of.pop(rid)
        self._free_lanes.append(lane)
        self.seq_len.pop(rid, None)
        self._finish(self.active.pop(rid))

    def _shed(self, req: Request, now: float) -> None:
        """Retire a request at admission under degraded paging
        (DESIGN.md §17.9): marked expired + slo_miss, counted in
        ``shed_requests`` (NOT ``expired`` — that counter means restart
        exhaustion), and moved to ``finished`` so the caller's drain loop
        observes it terminally instead of waiting out a doomed timeout."""
        req.expired = True
        req.slo_miss = True
        req.finished_at = now
        self.stats["shed_requests"] += 1
        self.stats["slo_misses"] += 1
        ts = self._tstats(req.tenant)
        ts["shed_requests"] += 1
        ts["slo_misses"] += 1
        self.finished.append(req)

    def _finish(self, req: Request) -> None:
        req.finished_at = time.time()
        if req.deadline_s is not None and req.first_submitted_at is not None \
                and req.finished_at - req.first_submitted_at > req.deadline_s:
            req.slo_miss = True
            self.stats["slo_misses"] += 1
            self._tstats(req.tenant)["slo_misses"] += 1
        ts = self._tstats(req.tenant)
        ts["finished"] += 1
        ts["tokens_generated"] += len(req.generated)
        self.finished.append(req)

    def _note_pool(self) -> None:
        used = self.allocator.used_pages
        if used > self.stats["peak_pages_used"]:
            self.stats["peak_pages_used"] = used

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.waiting and not self.active:
                break
            self.step()
        self._settle_prefill_times(wait=True)


# ---------------------------------------------------------------- helpers


def _install_pages(cache, k, v, pages, page_size, lane=None, prior_state=None):
    """Scatter contiguous prefilled KV [L, S, KVH, D] into pool pages, in
    place: one layered ``page_scatter`` per pool reads the KV where it lies
    (any layer stride) and writes zeros past S in the last page, as the JAX
    package pads it.  ``pages`` lists the physical pages receiving the S
    positions (S == 0 writes nothing — the whole span was prefix-shared).
    With ``prior_state`` (a hymba segment's prefill cache) the prefilled
    Mamba state (``ssm``, ``conv``) is copied into engine lane ``lane``, in
    place.  Returns ``cache``.
    """
    S = k.shape[1]
    if S:
        n_pages = -(-S // page_size)
        idx = torch.tensor(pages[:n_pages], dtype=torch.int32,
                           device=cache["k_pool"].device)
        for name, src in (("k_pool", k), ("v_pool", v)):
            pool = cache[name]
            page_scatter(pool_rows(pool), idx, token_rows(src.to(pool.dtype)))
    if prior_state is not None:
        for key in ("ssm", "conv"):
            cache[key][:, lane] = prior_state[key][:, 0]
    return cache


def _stacked(layer: dict, count: int) -> dict:
    """One layer's cache slice repeated over a segment's ``count`` layers."""
    return {k: t.unsqueeze(0).repeat((count,) + (1,) * t.dim()) for k, t in layer.items()}


def _copy_page(cache, ids):
    """Copy-on-write on the device: page ``ids[0]`` to page ``ids[1]`` in
    every layer of both pools, in place (the reference's
    ``pool.at[:, new].set(pool[:, old])``): one layered gather and one
    layered scatter per pool.  Returns ``cache``."""
    for name in ("k_pool", "v_pool"):
        rows = pool_rows(cache[name])
        page_scatter(rows, ids[1:], page_gather(rows, ids[:1]))
    return cache


def _copy_state_lane(cache, prefilled, lane):
    """Copy recurrent (mlstm/slstm) prefilled state into an engine lane, in
    place; returns ``cache``."""
    for key, dst in cache.items():
        dst[:, lane] = prefilled[key][:, 0]
    return cache
