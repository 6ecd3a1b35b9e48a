"""Pager-backed training state: params + AdamW moments behind UMap regions
(port of ``repro/train/paged_state.py``; numpy images, no tensor here).

The out-of-core trainer (DESIGN.md §18) keeps both the parameter tree and
the AdamW moment tree as *byte images behind UMap regions* instead of live
device arrays, so state can exceed the page buffer by any factor while the
sweep still sees plain ndarray views:

  pack_tree            flatten a pytree into a page-aligned byte image +
                       per-leaf page-extent specs (the layout contract)
  PagedTree            one pytree behind one region: chunked write-lease
                       sweeps, blocking consistent snapshots (§18.4)
  PagedOptimizerState  the AdamW (m, v) moments as ONE element-interleaved
                       image ``[m0 v0 m1 v1 ...]`` per leaf — the sweep
                       reads/writes each element's m and v through a
                       SINGLE lease run with strictly ascending page
                       numbers, which is what lets the access-pattern
                       classifier (core/pattern.py) settle on `sequential`
                       and the readahead window stay ahead of the sweep

Leaf order is ``interop.tree_flatten`` order, the JAX package's leaf
order — deterministic for a fixed tree structure, which is what makes the
page sweep monotone across leaves as well as within them, and what makes
a packed image byte for byte the JAX package's for the same numpy tree.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..interop import tree_flatten, tree_map, tree_unflatten

PyTree = Any


def pack_tree(tree: PyTree, page_size: int
              ) -> Tuple[np.ndarray, List[dict], Any]:
    """Pack a pytree into one page-aligned byte image.

    Returns ``(buf, specs, treedef)``: ``buf`` backs a UMap store
    (``HostArrayStore(buf)``), ``specs[i]`` records leaf ``i``'s
    shape/dtype/page extent, and ``treedef`` rebuilds the tree from leaf
    order.  Every leaf starts on a page boundary and is zero-padded to a
    whole number of pages, so lease views are always full aligned pages —
    the zero-staging-copy contract (DESIGN.md §13).
    """
    leaves, treedef = tree_flatten(tree)
    specs: List[dict] = []
    chunks: List[np.ndarray] = []
    page = 0
    for leaf in leaves:
        arr = np.ascontiguousarray(np.asarray(leaf))
        if page_size % arr.dtype.itemsize:
            raise ValueError(
                f"page_size {page_size} not a multiple of itemsize "
                f"{arr.dtype.itemsize}")
        flat = arr.view(np.uint8).reshape(-1)
        npages = max(1, -(-flat.nbytes // page_size))
        pad = npages * page_size - flat.nbytes
        chunks.append(flat)
        if pad:
            chunks.append(np.zeros(pad, np.uint8))
        specs.append({"shape": tuple(arr.shape), "dtype": str(arr.dtype),
                      "first_page": page, "npages": npages,
                      "nbytes": int(flat.nbytes)})
        page += npages
    return np.concatenate(chunks), specs, treedef


class PagedTree:
    """One pytree behind one UMap region (layout from :func:`pack_tree`).

    The write path is the zero-copy lease sweep: ``leaf_page_runs`` grants
    chunked ``lease_run`` views the caller mutates in place — no staging
    memcpy between the page buffer and the application (``staging_copies``
    counts the copy-backed fallback, asserted zero by the differential
    suite).  The read path for checkpointing is ``snapshot_tree``: chunked
    ``exclude_writers`` read leases that BLOCK while any write lease is
    live (§18.4), so a snapshot never captures a page mid-mutation.
    """

    def __init__(self, region, specs: Sequence[dict], treedef):
        self.region = region
        self.specs = list(specs)
        self.treedef = treedef
        self.staging_copies = 0       # copy-backed lease grants (telemetry)

    # Ceiling on pages per lease run, re-derived from the live service
    # config so chunks always respect min(max_lease_run, num_slots // 2);
    # halved again to leave eviction headroom for the opposing region.
    def max_run_pages(self) -> int:
        svc = self.region.service
        cap = max(1, min(svc.config.max_lease_run,
                         svc.buffer.num_slots // 2))
        return max(1, cap // 2)

    @property
    def num_leaves(self) -> int:
        return len(self.specs)

    def total_pages(self) -> int:
        return sum(s["npages"] for s in self.specs)

    def nbytes(self) -> int:
        return sum(s["nbytes"] for s in self.specs)

    def _count_staging(self, run) -> None:
        self.staging_copies += sum(1 for ls in run if not ls.zero_copy)

    def leaf_chunks(self, leaf: int,
                    chunk_pages: Optional[int] = None) -> List[Tuple[int, int]]:
        """``(offset, pages)`` of each lease run covering leaf ``leaf``, in
        ascending page order: ``chunk_pages`` (default
        :meth:`max_run_pages`) at a time, each cut to the longest run the
        service can grant (``lease_run_limit``: no metadata stripe given
        more pages than it owns slots).  Deterministic given the region
        and its service."""
        spec = self.specs[leaf]
        step = chunk_pages or self.max_run_pages()
        svc = self.region.service
        out, off = [], 0
        while off < spec["npages"]:
            n = svc.lease_run_limit(self.region, spec["first_page"] + off,
                                    min(step, spec["npages"] - off))
            out.append((off, n))
            off += n
        return out

    def leaf_page_runs(self, leaf: int, write: bool = False,
                       chunk_pages: Optional[int] = None,
                       first_chunk: int = 0) -> Iterator[Tuple[int, Any]]:
        """Yield ``(chunk_index, LeaseRun)`` covering leaf ``leaf``'s pages.

        Chunk boundaries are deterministic (:meth:`leaf_chunks`), which is
        what lets the chaos-retry path skip chunks already applied.  The
        caller must release each run (use ``with``) before the next is
        granted — one live run per region per thread, the no-self-livelock
        discipline.
        """
        first = self.specs[leaf]["first_page"]
        for ci, (off, n) in enumerate(self.leaf_chunks(leaf, chunk_pages)):
            if ci < first_chunk:
                continue
            run = self.region.lease_run(first + off, n, write=write)
            self._count_staging(run)
            yield ci, run

    def num_chunks(self, leaf: int,
                   chunk_pages: Optional[int] = None) -> int:
        return len(self.leaf_chunks(leaf, chunk_pages))

    # ------------------------------------------------------------ snapshot

    def snapshot_leaf(self, leaf: int) -> np.ndarray:
        """Consistent copy of one leaf via ``exclude_writers`` read leases.

        Blocks until live write leases on each page release; excludes new
        write leases page-by-page while copying (§18.4).
        """
        spec = self.specs[leaf]
        out = np.empty(spec["npages"] * self.region.page_size, np.uint8)
        ps = self.region.page_size
        for off, n in self.leaf_chunks(leaf):
            with self.region.lease_run(spec["first_page"] + off, n,
                                       exclude_writers=True) as run:
                self._count_staging(run)
                for j, view in enumerate(run.views):
                    lo = (off + j) * ps
                    out[lo:lo + view.nbytes] = view.view(np.uint8)
        return (out[:spec["nbytes"]].view(np.dtype(spec["dtype"]))
                .reshape(spec["shape"]))

    def snapshot_tree(self) -> PyTree:
        """Consistent host copy of the whole tree (blocks on write leases).

        Duck-typed by ``AsyncCheckpointer.save_async``: a tree leaf with a
        ``snapshot_tree`` method is materialized through this call, so a
        save forced during an in-flight ``lease_run`` update waits for the
        lease to release instead of copying mid-mutation bytes.
        """
        return tree_unflatten(
            self.treedef,
            [self.snapshot_leaf(i) for i in range(self.num_leaves)])

    # ------------------------------------------------------------- restore

    def load_leaf(self, leaf: int, arr: np.ndarray) -> None:
        """Overwrite one leaf's bytes through the region (dirty-tracked)."""
        spec = self.specs[leaf]
        arr = np.ascontiguousarray(np.asarray(arr))
        if arr.shape != spec["shape"] or str(arr.dtype) != spec["dtype"]:
            raise ValueError(
                f"leaf {leaf}: cannot load {arr.dtype}{arr.shape} into "
                f"{spec['dtype']}{spec['shape']}")
        self.region.write(spec["first_page"] * self.region.page_size,
                          arr.view(np.uint8).reshape(-1))

    def load_tree(self, tree: PyTree) -> None:
        leaves = tree_flatten(tree)[0]
        if len(leaves) != self.num_leaves:
            raise ValueError(f"tree has {len(leaves)} leaves, "
                             f"expected {self.num_leaves}")
        for i, leaf in enumerate(leaves):
            self.load_leaf(i, leaf)


def interleave_moments(m_tree: PyTree, v_tree: PyTree) -> PyTree:
    """Fuse (m, v) trees into per-leaf element-interleaved flats.

    Leaf ``i`` becomes a 1-D fp32 array ``[m0 v0 m1 v1 ...]`` of length
    ``2n`` — adjacent (m, v) per element, so the optimizer sweep touches
    each element's full state through ONE strictly-sequential page run.
    """
    return tree_map(
        lambda m, v: np.stack(
            [np.asarray(m, np.float32).reshape(-1),
             np.asarray(v, np.float32).reshape(-1)], axis=1).reshape(-1),
        m_tree, v_tree)


def split_moments(mv_flat: np.ndarray, shape: tuple
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`interleave_moments` for one leaf."""
    return (mv_flat[0::2].reshape(shape).copy(),
            mv_flat[1::2].reshape(shape).copy())


class PagedOptimizerState:
    """AdamW moments behind a UMap region, plus the host step counter.

    ``mv`` is a :class:`PagedTree` whose leaf ``i`` is the interleaved
    ``[m v]`` flat for parameter leaf ``i`` (see
    :func:`interleave_moments`); ``param_specs`` keeps the original leaf
    shapes for snapshot/restore.  The region is typically backed by a
    ``TieredStore`` and advised ``sequential`` with a ``tier_hint`` on the
    hot layer window — see ``OOCTrainer._mount``.
    """

    def __init__(self, mv: PagedTree, param_shapes: List[tuple],
                 step: int = 0):
        self.mv = mv
        self.param_shapes = list(param_shapes)
        self.step = step

    @property
    def region(self):
        return self.mv.region

    @property
    def staging_copies(self) -> int:
        return self.mv.staging_copies

    def snapshot_tree(self) -> dict:
        """Blocking consistent snapshot as separate {m, v} trees.

        The split trees structurally match the parameter tree
        (``distributed/elastic.reshard_tree`` places them onto a new mesh
        with the parameters' own logical-axis rules).
        """
        mv_leaves = [self.mv.snapshot_leaf(i)
                     for i in range(self.mv.num_leaves)]
        pairs = [split_moments(mv, shp)
                 for mv, shp in zip(mv_leaves, self.param_shapes)]
        m_tree = tree_unflatten(self.mv.treedef, [p[0] for p in pairs])
        v_tree = tree_unflatten(self.mv.treedef, [p[1] for p in pairs])
        return {"m": m_tree, "v": v_tree}

    def load(self, m_tree: PyTree, v_tree: PyTree, step: int) -> None:
        self.mv.load_tree(interleave_moments(m_tree, v_tree))
        self.step = int(step)


def build_paged_tree(tree: PyTree, page_size: int,
                     store_factory: Callable[[np.ndarray], Any],
                     config=None, service=None, **region_kw) -> PagedTree:
    """Pack ``tree`` and mount it as a region: the one-stop constructor.

    ``store_factory(buf)`` turns the packed byte image into a
    ``BackingStore`` (plain ``HostArrayStore``, a ``TieredStore`` over it,
    a ``ChaosStore`` wrapper for fault drills, ...).
    """
    from ..core.region import umap

    buf, specs, treedef = pack_tree(tree, page_size)
    store = store_factory(buf)
    region = umap(store, config=config, service=service, **region_kw)
    return PagedTree(region, specs, treedef)
