"""Out-of-core training through the paging stack (DESIGN.md §18); port of
``repro/train/ooc.py``.

The training state — fp32 parameters plus AdamW moments — lives behind
UMap regions in host memory instead of in device tensors, so state can
exceed the page buffer by 4x or more while the step loop stays a plain
PyTorch program:

  grad phase    parameters stream leaf by leaf through the zero-copy
                lease path (``serve.weight_pager.RegionLayerSource``) into
                the device: lease views are copied to the card by address
                and installed into a device page pool with ``page_scatter``,
                and each leaf is assembled with ``page_gather`` (the CUDA
                kernels on the card).  The leaves are detached and marked
                ``requires_grad`` for ``torch.autograd.grad``, so no graph
                reaches the source's pool.  The per-step scalar bundle
                (clip scale, lr, bias corrections) is computed ONCE from
                the global grad norm (``optimizer.update_scalars``).
  sweep phase   parameters and moments are updated IN PLACE through
                chunked write ``lease_run`` views: each chunk's pages are
                copied to the device, updated by the purely elementwise
                ``optimizer.adamw_elementwise`` (one call over the chunk's
                pages joined, which per element is the reference's
                per-page call), and copied back — so chunking is
                bitwise-identical to whole-leaf AdamW.  Moments are
                element-interleaved ``[m0 v0 m1 v1 ...]``
                (train/paged_state.py), giving ONE strictly ascending
                page run per chunk — the access pattern the classifier
                settles on `sequential` and readahead stays ahead of.

``paged=False`` runs the SAME chunk-granular decomposed sweep over plain
numpy buffers — identical chunk boundaries, identical device arithmetic,
no pager.  That is both the bitwise reference for the differential suite
(tests/test_torch_train_ooc.py) and the resident baseline of the
``step_time_ratio``: the paged/resident delta is pure pager overhead.

Fault handling (§14.4/§17): every pager I/O fault surfaces BEFORE any
in-place mutation of the faulting chunk (lease grants fault; the compute
then runs on already-resident views, and results are written back only
after the whole chunk is computed), so a chunk is atomic — it either
fully applied or raised.  ``step()`` stashes the grad phase's results and
retries the sweep, skipping chunks already applied; a step therefore
completes bitwise-exact or raises ``OSError`` — never silent corruption.
The stash stays on the device as flat fp32 gradient tensors and 0-d fp32
scalars: nothing writes them after the grad phase, so a retry replays
them bitwise without copying the gradients to the host and back.

The trainer runs on ``device`` (default ``"cuda"``, which raises without a
card; the tests pass ``"cpu"``).  ``params`` is an optional numpy tree in
the JAX package's layout; without it the port's ``init_params(cfg, seed)``
draws the weights.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ckpt import checkpoint as ckpt
from ..configs.base import ModelConfig
from ..core.config import UMapConfig
from ..core.hints import AccessAdvice
from ..core.region import umap, uunmap
from ..core.store import HostArrayStore, TieredStore
from ..interop import to_numpy, tree_flatten, tree_map, tree_unflatten
from ..models import transformer as T
from ..serve.weight_pager import RegionLayerSource, _copy_in, _landed
from .optimizer import adamw_elementwise, global_norm, update_scalars
from .paged_state import (PagedOptimizerState, PagedTree, interleave_moments,
                          pack_tree, split_moments)
from .trainer import to_device
from .train_step import TrainConfig, value_and_grad

PyTree = Any
StoreFactory = Callable[[np.ndarray], Any]


def _host(a) -> np.ndarray:
    """A state leaf (tensor, numpy array or number) as host numpy."""
    return to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclasses.dataclass
class OOCTrainerConfig:
    """Knobs for the paged training loop (DESIGN.md §18.1).

    ``*_buffer_pages`` size each region's page buffer; 0 means "resident"
    (a buffer as large as the state), so oversubscription is the explicit
    choice of a smaller number.  The sweep chunk is measured in PARAMETER
    pages; each chunk additionally pins up to ``2 * sweep_chunk_pages``
    moment pages (the interleaved layout stores 2 fp32 per element).
    """

    page_size: int = 64 * 1024
    params_buffer_pages: int = 0      # 0 = hold every params page
    moments_buffer_pages: int = 0     # 0 = hold every moments page
    sweep_chunk_pages: int = 0        # params pages per chunk (0 = auto)
    max_lease_run: int = 64           # raised automatically to the largest leaf
    advise_moments: bool = True       # advise(SEQUENTIAL) on the moments region
    adaptive: bool = False            # let the online classifier drive instead
    moments_fast_tier_bytes: int = 0  # >0: TieredStore-backed moments
    moments_tier_chain: str = ""      # N-tier cache spec (UMAP_TIER_CHAIN
    #   syntax, e.g. "host:8m,file:/tmp/mid:32m"); overrides
    #   moments_fast_tier_bytes when set — the packed image is the base tier
    hot_window_leaves: int = 0        # leading leaves tier-hinted "hot"
    pool_pages: int = 0               # device pool for the param source (0 = all)
    max_step_retries: int = 3         # sweep retries after an I/O fault
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0               # 0 = only explicit save_checkpoint()
    keep_ckpts: int = 3
    log_every: int = 10


def _page_update(ocfg, p, g, mv, scale, lr, bc1, bc2):
    """A run of parameter pages' AdamW update against their interleaved
    moments ``mv = [m0 v0 m1 v1 ...]`` (twice ``p``'s length).  Purely
    elementwise — chunk-sized application is bitwise-identical to
    page-sized and to whole-leaf application, and the SAME code serves the
    paged sweep and the resident reference."""
    p2, m2, v2 = adamw_elementwise(ocfg, p, g, mv[0::2], mv[1::2], scale, lr, bc1, bc2)
    return p2, torch.stack([m2, v2], dim=1).reshape(-1)


class OOCTrainer:
    """Trainer whose params + optimizer state live behind UMap regions.

    ``paged=False`` is the resident reference: the same packed layouts,
    chunk boundaries, and device arithmetic over plain numpy buffers — the
    two modes are bitwise-identical by construction, so the differential
    suite pins the pager's correctness and the step-time ratio isolates
    its cost.

    ``params_store_factory`` / ``moments_store_factory`` map the packed
    byte image to a ``BackingStore`` — the injection point for
    ``TieredStore`` layering or the chaos harness (``ChaosStore``).
    """

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 ocfg: OOCTrainerConfig,
                 seed: int = 0, paged: bool = True,
                 params_store_factory: Optional[StoreFactory] = None,
                 moments_store_factory: Optional[StoreFactory] = None,
                 ckpt_store=None, params: Optional[PyTree] = None,
                 device="cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.ocfg = ocfg
        self.paged = paged
        self.device = resolve_device(device)
        self.step_no = 0
        ps = ocfg.page_size
        if ps % 4:
            raise ValueError(f"page_size {ps} must hold whole fp32 elements")
        self._pe = ps // 4                     # fp32 elements per page

        params = (tree_map(np.asarray, params) if params is not None
                  else tree_map(to_numpy, T.init_params(cfg, seed, device="cpu")))
        for leaf in tree_flatten(params)[0]:
            if leaf.dtype != np.float32:
                raise ValueError(
                    f"OOC training sweeps fp32 state; got a {leaf.dtype} leaf")
        mv_zero = tree_map(lambda p: np.zeros(2 * int(p.size), np.float32), params)

        self._p_buf, self._p_specs, self.treedef = pack_tree(params, ps)
        self._mv_buf, self._mv_specs, _ = pack_tree(mv_zero, ps)
        self._num_leaves = len(self._p_specs)

        self._params: Optional[PagedTree] = None
        self.opt: Optional[PagedOptimizerState] = None
        self.source: Optional[RegionLayerSource] = None
        if paged:
            self._mount(params_store_factory, moments_store_factory)
        self._plan_chunks()

        self._pending: Optional[dict] = None
        self.metrics_log: List[dict] = []
        self.stats = {
            "steps": 0, "step_retries": 0, "io_errors": 0,
            "sweep_chunks": 0, "sweep_pages": 0, "ckpt_saves": 0,
            "quarantine_retries": 0, "last_step_s": 0.0,
            # the last step's host seconds: its grad phase (leaf fetches,
            # forward, backward) and its sweep, and of the sweep the time
            # in the chunks' host <-> device copies (the copy back waits
            # for the chunk's update to finish)
            "last_grad_s": 0.0, "last_sweep_s": 0.0, "last_sweep_copy_s": 0.0,
        }
        self.ckptr = (ckpt.AsyncCheckpointer(
            ocfg.ckpt_dir or "", keep=ocfg.keep_ckpts, store=ckpt_store)
            if (ocfg.ckpt_dir or ckpt_store is not None) else None)

    # ------------------------------------------------------------ construction

    def _mount(self, p_factory: Optional[StoreFactory],
               mv_factory: Optional[StoreFactory]) -> None:
        ocfg = self.ocfg
        ps = ocfg.page_size
        p_total = self._p_buf.nbytes // ps
        mv_total = self._mv_buf.nbytes // ps
        largest = max(s["npages"] for s in self._p_specs)
        # The grad phase leases whole leaves (RegionLayerSource), so the
        # params run cap — min(max_lease_run, slots // 2) — must cover the
        # largest leaf.
        run_cap = max(ocfg.max_lease_run, largest)
        p_slots = ocfg.params_buffer_pages or p_total
        if p_slots < 2 * largest:
            raise ValueError(
                f"params_buffer_pages={p_slots} cannot lease the largest "
                f"leaf ({largest} pages need >= {2 * largest} slots)")
        mv_slots = ocfg.moments_buffer_pages or mv_total
        if mv_slots < 4:
            raise ValueError(f"moments_buffer_pages={mv_slots} too small "
                             f"(need >= 4)")

        p_cfg = UMapConfig(page_size=ps, buffer_size=p_slots * ps,
                           max_lease_run=run_cap)
        mv_cfg = UMapConfig(page_size=ps, buffer_size=mv_slots * ps,
                            max_lease_run=run_cap, adaptive=ocfg.adaptive)

        p_store = (p_factory or HostArrayStore)(self._p_buf)
        self._params = PagedTree(umap(p_store, config=p_cfg),
                                 self._p_specs, self.treedef)
        self.source = RegionLayerSource(
            self._params.region, self._p_specs, device=self.device,
            pool_pages=ocfg.pool_pages or None)

        if mv_factory is None:
            if ocfg.moments_tier_chain:
                spec = ocfg.moments_tier_chain

                def mv_factory(buf, _spec=spec):
                    from ..core.store import (TierChain, build_tier_stores,
                                              parse_tier_chain)
                    caches = build_tier_stores(_spec)
                    sizes = [args[-1] for _, args in parse_tier_chain(_spec)]
                    return TierChain(
                        caches + [HostArrayStore(buf)],
                        extent_size=min(1 << 20, *sizes),
                        budgets=sizes)
            elif ocfg.moments_fast_tier_bytes > 0:
                fast = ocfg.moments_fast_tier_bytes

                def mv_factory(buf, _fast=fast):
                    return TieredStore(
                        HostArrayStore(np.zeros(_fast, np.uint8)),
                        HostArrayStore(buf), fast_bytes=_fast,
                        extent_size=min(1 << 20, _fast))
            else:
                mv_factory = HostArrayStore
        mv_store = mv_factory(self._mv_buf)
        mv_region = umap(mv_store, config=mv_cfg)
        self.opt = PagedOptimizerState(
            PagedTree(mv_region, self._mv_specs, self.treedef),
            [s["shape"] for s in self._p_specs])
        # Application knowledge first (paper §3.6): the sweep is strictly
        # sequential over the moments image.  adaptive mode leaves the
        # region un-hinted so the online classifier earns the same answer.
        if ocfg.advise_moments and not ocfg.adaptive:
            mv_region.advise(advice=AccessAdvice.SEQUENTIAL)
        if ocfg.hot_window_leaves > 0 and mv_region.tiered:
            for spec in self._mv_specs[:ocfg.hot_window_leaves]:
                mv_region.advise(tier_hint="hot",
                                 offset=spec["first_page"] * ps,
                                 nbytes=spec["npages"] * ps)

    def _plan_chunks(self) -> None:
        """Fix the sweep chunk size (in PARAMS pages) for this run.

        Deterministic given the config, and shared by the paged and
        resident modes — identical chunk boundaries are what make the
        two bitwise-comparable.  Each chunk pins one params run (R pages)
        and one moments run (<= 2R pages) on two independent services.
        """
        ocfg = self.ocfg
        if ocfg.sweep_chunk_pages:
            self.chunk_pages = ocfg.sweep_chunk_pages
        elif not self.paged:
            self.chunk_pages = max(1, ocfg.max_lease_run // 2)
        else:
            p_svc = self._params.region.service
            mv_svc = self.opt.region.service
            p_cap = min(p_svc.config.max_lease_run,
                        p_svc.buffer.num_slots // 2)
            mv_cap = min(mv_svc.config.max_lease_run,
                         mv_svc.buffer.num_slots // 2)
            self.chunk_pages = max(1, min(p_cap, mv_cap // 2))
        self._chunks = [self._leaf_chunks(leaf) for leaf in range(self._num_leaves)]

    def _leaf_chunks(self, leaf: int) -> List[Tuple[int, int]]:
        """``(first params page, params pages)`` of each sweep chunk of
        ``leaf``: ``chunk_pages`` at a time, in paged mode cut until both
        the params run and the moments run fit their buffers' stripes
        (``lease_run_limit``).  The sweep's result does not depend on the
        cut: every element is updated alone."""
        npages = self._p_specs[leaf]["npages"]
        R = self.chunk_pages
        if not self.paged:
            return [(lo, min(R, npages - lo)) for lo in range(0, npages, R)]
        p_region, mv_region = self._params.region, self.opt.mv.region
        p_first0 = self._p_specs[leaf]["first_page"]
        mv_first0 = self._mv_specs[leaf]["first_page"]
        out, lo = [], 0
        while lo < npages:
            n = p_region.service.lease_run_limit(p_region, p_first0 + lo,
                                                 min(R, npages - lo))
            while n > 1:
                mv_first, mv_n = self._mv_span(leaf, lo, n)
                if mv_region.service.lease_run_limit(
                        mv_region, mv_first0 + mv_first, mv_n) == mv_n:
                    break
                n -= 1
            out.append((lo, n))
            lo += n
        return out

    def _mv_span(self, leaf: int, p_first: int, p_n: int) -> Tuple[int, int]:
        """(first moments page, moments pages) of the params pages
        ``[p_first, p_first + p_n)`` of ``leaf``: the interleaved (m, v)
        of its elements."""
        n = self._p_specs[leaf]["nbytes"] // 4
        hi = min(n, (p_first + p_n) * self._pe)
        mv_first = 2 * p_first                        # 2*lo/pe: page-aligned
        return mv_first, -(-2 * hi // self._pe) - mv_first

    # ------------------------------------------------------------- geometry

    def state_bytes(self) -> int:
        return self._p_buf.nbytes + self._mv_buf.nbytes

    def buffer_bytes(self) -> int:
        if not self.paged:
            return self.state_bytes()
        return (self._params.region.service.config.buffer_size
                + self.opt.region.service.config.buffer_size)

    def oversubscription(self) -> float:
        return self.state_bytes() / max(1, self.buffer_bytes())

    @property
    def staging_copies(self) -> int:
        if not self.paged:
            return 0
        return (self._params.staging_copies + self.opt.staging_copies
                + self.source.staging_copies)

    def _regions(self):
        return ([] if not self.paged
                else [self._params.region, self.opt.region])

    # ------------------------------------------------------------ grad phase

    def _value_grad(self, params: PyTree, batch: dict):
        loss, metrics, grads = value_and_grad(self.cfg, self.tcfg, params, batch)
        return loss, metrics, grads, global_norm(grads)

    def _leaf_resident(self, i: int, buf: np.ndarray, specs) -> np.ndarray:
        s = specs[i]
        n = s["nbytes"] // 4
        return buf[s["first_page"] * self.ocfg.page_size:][:s["nbytes"]] \
            .view(np.float32)[:n]

    def _device_params(self) -> PyTree:
        """The parameters on the device, as new tensors (the source's
        gathers, or copies of the resident image) that share nothing with
        the state the sweep mutates."""
        if self.paged:
            leaves = [self.source[i] for i in range(self._num_leaves)]
        else:
            leaves = [torch.from_numpy(self._leaf_resident(i, self._p_buf, self._p_specs))
                      .to(self.device, copy=True).reshape(self._p_specs[i]["shape"])
                      for i in range(self._num_leaves)]
        return tree_unflatten(self.treedef, leaves)

    def _prepare_update(self, batch: dict) -> None:
        """Grad phase: read-only over params, so a fault here is retried
        by simply re-running — nothing has been stashed or mutated."""
        t0 = time.perf_counter()
        params = self._device_params()
        loss, metrics, grads, gnorm = self._value_grad(params, to_device(batch, self.device))
        scalars = update_scalars(
            self.tcfg.optimizer,
            torch.tensor(self.step_no, dtype=torch.int32, device=self.device), gnorm)
        out = {k: float(v) for k, v in metrics.items()}
        out["grad_norm"] = float(gnorm)
        out["lr"] = float(scalars[1])
        # Stash grads + scalars on the device: a sweep retry after an I/O
        # fault replays EXACTLY these values (bitwise), never recomputes.
        self._pending = {
            "grads": [g.float().reshape(-1) for g in tree_flatten(grads)[0]],
            "scalars": scalars,
            "metrics": out,
            "done": set(),
        }
        self.stats["last_grad_s"] += time.perf_counter() - t0

    # ----------------------------------------------------------- sweep phase

    def _chunk_views(self, leaf: int, ci: int
                     ) -> Tuple[List[np.ndarray], List[np.ndarray],
                                Callable[[], None], Callable[[], None]]:
        """Grant chunk ``ci`` of leaf ``leaf``: full-page fp32 views over
        params and moments, plus ``(commit, abort)``.

        All pager faults happen HERE (lease grants); ``abort`` unwinds
        with no dirty marks, which is only sound because the sweep writes
        views strictly after every grant succeeded.
        """
        pspec, mvspec = self._p_specs[leaf], self._mv_specs[leaf]
        p_first, p_n = self._chunks[leaf][ci]
        mv_first, mv_n = self._mv_span(leaf, p_first, p_n)
        if not self.paged:
            p_views = [self._page_resident(self._p_buf,
                                           pspec["first_page"] + p_first + j)
                       for j in range(p_n)]
            mv_views = [self._page_resident(self._mv_buf,
                                            mvspec["first_page"] + mv_first + j)
                        for j in range(mv_n)]

            def noop():
                pass
            return p_views, mv_views, noop, noop
        p_run = self._params.region.lease_run(
            pspec["first_page"] + p_first, p_n, write=True)
        self._params._count_staging(p_run)
        try:
            mv_run = self.opt.mv.region.lease_run(
                mvspec["first_page"] + mv_first, mv_n, write=True)
        except BaseException:
            for ls in p_run:
                ls.abandon()
            raise
        self.opt.mv._count_staging(mv_run)

        def commit():
            p_run.release()
            mv_run.release()

        def abort():
            for ls in list(p_run) + list(mv_run):
                ls.abandon()

        return ([v.view(np.float32) for v in p_run.views],
                [v.view(np.float32) for v in mv_run.views], commit, abort)

    def _page_resident(self, buf: np.ndarray, page: int) -> np.ndarray:
        ps = self.ocfg.page_size
        return buf[page * ps:(page + 1) * ps].view(np.float32)

    def _upload(self, views: List[np.ndarray]) -> torch.Tensor:
        """Full-page fp32 views -> a ``[n, page_elems]`` device tensor, each
        view copied by address (``copy_h2d``) on the card."""
        out = torch.empty((len(views), self._pe), dtype=torch.float32, device=self.device)
        for row, view in zip(out.view(torch.uint8), views):
            _copy_in(row, view)
        return out

    def _download(self, pages: torch.Tensor, views: List[np.ndarray]) -> None:
        """Each row of ``pages`` back into its page view (synchronous)."""
        for row, view in zip(pages, views):
            if row.is_cuda:
                torch.from_numpy(view).copy_(row)
            else:
                view[:] = row.numpy()

    def _apply_chunk(self, leaf: int, ci: int) -> None:
        n = self._p_specs[leaf]["nbytes"] // 4
        lo = self._chunks[leaf][ci][0] * self._pe
        grads = self._pending["grads"][leaf]
        p_views, mv_views, commit, abort = self._chunk_views(leaf, ci)
        try:
            # Compute the whole chunk's result BEFORE mutating any view:
            # the chunk-atomicity invariant the retry path depends on.
            t0 = time.perf_counter()
            p_dev, mv_dev = self._upload(p_views), self._upload(mv_views)
            _landed(self.device)
            copy_s = time.perf_counter() - t0
            hi = min(n, lo + len(p_views) * self._pe)
            p_flat, mv_flat = p_dev.view(-1), mv_dev.view(-1)
            p2, mv2 = _page_update(self.tcfg.optimizer, p_flat[:hi - lo], grads[lo:hi],
                                   mv_flat[:2 * (hi - lo)], *self._pending["scalars"])
            # the pages' bytes past the leaf stay as they were
            p_flat[:hi - lo] = p2
            mv_flat[:2 * (hi - lo)] = mv2
        except BaseException:
            _landed(self.device)        # no copy may still read a view
            abort()
            raise
        t0 = time.perf_counter()
        self._download(p_dev, p_views)
        self._download(mv_dev, mv_views)
        self.stats["last_sweep_copy_s"] += copy_s + time.perf_counter() - t0
        commit()
        self.stats["sweep_chunks"] += 1
        self.stats["sweep_pages"] += len(p_views) + len(mv_views)

    def _apply_pending(self) -> None:
        done = self._pending["done"]
        for leaf in range(self._num_leaves):
            for ci in range(len(self._chunks[leaf])):
                if (leaf, ci) in done:
                    continue
                self._apply_chunk(leaf, ci)
                done.add((leaf, ci))

    # ------------------------------------------------------------------ step

    def step(self, batch: dict) -> dict:
        """One optimizer step; retries the sweep across transient I/O
        faults (bitwise-exact — stashed grads/scalars, chunk done-set) and
        raises ``OSError`` when the store stays down."""
        t0 = time.perf_counter()
        for key in ("last_grad_s", "last_sweep_s", "last_sweep_copy_s"):
            self.stats[key] = 0.0
        for attempt in range(self.ocfg.max_step_retries + 1):
            try:
                if self._pending is None:
                    self._prepare_update(batch)
                t1 = time.perf_counter()
                try:
                    self._apply_pending()
                finally:
                    self.stats["last_sweep_s"] += time.perf_counter() - t1
                break
            except OSError:
                self.stats["io_errors"] += 1
                if attempt >= self.ocfg.max_step_retries:
                    raise
                self.stats["step_retries"] += 1
                self.drain_quarantine()
        metrics = self._pending["metrics"]
        self._pending = None
        self.step_no += 1
        if self.paged:
            # The sweep mutated the params region; cached device layers in
            # the grad-phase source are stale.
            self.source.invalidate()
        self.stats["steps"] += 1
        self.stats["last_step_s"] = time.perf_counter() - t0
        return metrics

    def fit(self, batches: Iterable[dict]) -> dict:
        for batch in batches:
            if self.step_no >= self.ocfg.total_steps:
                break
            metrics = self.step(batch)
            if (self.step_no % self.ocfg.log_every == 0
                    or self.step_no == 1):
                m = dict(metrics)
                m["step"] = self.step_no
                self.metrics_log.append(m)
            if (self.ckptr and self.ocfg.ckpt_every
                    and self.step_no % self.ocfg.ckpt_every == 0):
                self.save_checkpoint()
        return {"final_step": self.step_no,
                "loss": self.metrics_log[-1]["loss"]
                if self.metrics_log else None,
                "history": self.metrics_log}

    # ----------------------------------------------------------- fault tools

    def drain_quarantine(self) -> int:
        """Re-post quarantined dirty pages for cleaning (§17.4)."""
        n = 0
        for region in self._regions():
            n += region.service.retry_quarantined(region)
        self.stats["quarantine_retries"] += n
        return n

    # ---------------------------------------------------------- state access

    def state_dict(self) -> dict:
        """Consistent host copy: ``{"params", "opt": {"m", "v"}, "step"}``.

        Paged mode snapshots through ``exclude_writers`` leases (§18.4),
        so a copy taken concurrently with a sweep never sees a page
        mid-mutation."""
        if self.paged:
            params = self._params.snapshot_tree()
            opt = self.opt.snapshot_tree()
        else:
            params = tree_unflatten(
                self.treedef,
                [np.array(self._leaf_resident(i, self._p_buf, self._p_specs))
                 .reshape(self._p_specs[i]["shape"])
                 for i in range(self._num_leaves)])
            pairs = [split_moments(
                np.array(self._leaf_resident(i, self._mv_buf,
                                             self._mv_specs)),
                self._p_specs[i]["shape"])
                for i in range(self._num_leaves)]
            opt = {"m": tree_unflatten(self.treedef, [p[0] for p in pairs]),
                   "v": tree_unflatten(self.treedef, [p[1] for p in pairs])}
        return {"params": params, "opt": opt, "step": self.step_no}

    def load_state_dict(self, state: dict) -> None:
        # Store-path checkpoints round-trip the scalar step as shape (1,).
        step = int(_host(state["step"]).reshape(-1)[0])
        params = tree_map(_host, state["params"])
        m = tree_map(lambda a: _host(a).astype(np.float32, copy=False), state["opt"]["m"])
        v = tree_map(lambda a: _host(a).astype(np.float32, copy=False), state["opt"]["v"])
        if self.paged:
            self._params.load_tree(params)
            self.opt.load(m, v, step)
            self.source.invalidate()
        else:
            for i, leaf in enumerate(tree_flatten(params)[0]):
                self._leaf_resident(i, self._p_buf, self._p_specs)[:] = \
                    np.asarray(leaf, np.float32).reshape(-1)
            mv = interleave_moments(m, v)
            for i, leaf in enumerate(tree_flatten(mv)[0]):
                self._leaf_resident(i, self._mv_buf, self._mv_specs)[:] = leaf
        self.step_no = step
        self._pending = None

    # ---------------------------------------------------------- checkpointing

    def save_checkpoint(self) -> None:
        """Async save through the §18.4 snapshot path.

        The PagedTree / PagedOptimizerState leaves are duck-typed by
        ``AsyncCheckpointer.save_async`` (``snapshot_tree``), which blocks
        on in-flight write leases instead of copying torn bytes."""
        if self.ckptr is None:
            raise RuntimeError("no checkpointer configured "
                               "(set ckpt_dir or pass ckpt_store)")
        if self.paged:
            tree = {"params": self._params, "opt": self.opt,
                    "step": self.step_no}
        else:
            tree = self.state_dict()
        self.ckptr.save_async(self.step_no, tree)
        self.stats["ckpt_saves"] += 1

    def try_resume(self) -> bool:
        if not self.ocfg.ckpt_dir:
            return False
        step = ckpt.latest_step(self.ocfg.ckpt_dir)
        if step is None:
            return False
        like = self.state_dict()
        self.load_state_dict(ckpt.restore(self.ocfg.ckpt_dir, step, like))
        return True

    # --------------------------------------------------------------- control

    def flush(self) -> None:
        for region in self._regions():
            region.flush()

    def register_telemetry(self, registry=None, label=None) -> str:
        from ..telemetry import default_registry
        from ..telemetry.collectors import TrainCollector
        reg = registry if registry is not None else default_registry()
        return reg.register(TrainCollector(trainer=self, label=label))

    def close(self) -> None:
        if self.ckptr is not None:
            self.ckptr.close()
        for region in self._regions():
            uunmap(region)
