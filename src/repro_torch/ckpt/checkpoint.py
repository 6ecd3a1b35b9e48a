"""Checkpointing with watermark-driven async flush (port of
``repro/ckpt/checkpoint.py``).

Save layout (one directory per step), as in the JAX package:

    ckpt_dir/step_000123/
      manifest.json        tree structure, per-leaf shape/dtype, step
      leaf_00000.npy ...   one file per leaf, in ``interop.tree_flatten``
                           order (the JAX package's leaf order)

A leaf is a torch tensor (copied to host numpy; bf16 as its ``uint16`` bit
pattern, ``interop.to_numpy``), a numpy array or a Python number.  The
``.npy`` files and the store images are byte for byte the JAX package's
for the same tree: a 0-d int32 tensor (``AdamWState.step``) is saved as
int32, a Python int (the trainer's top-level ``step``) as int64, as there.
So a checkpoint written by either package restores in the other.  In the
manifests, ``treedef`` is informational: it is this package's treedef
printed, not JAX's, and neither package's ``restore`` reads it (they
rebuild the tree from ``like``); ``shape``, ``dtype``, ``nbytes`` and
``offset`` are what a restore reads.

Fault-tolerance properties (DESIGN.md §4):
  * atomic publish — written to a tmp dir, fsync'd, then renamed; a crash
    mid-save never corrupts the latest checkpoint;
  * async flush — saves are queued to evictor-style writer threads; the
    dirty-step watermark bounds how many unflushed steps may accumulate
    before the training loop blocks (the paper's high/low watermark applied
    to checkpoint persistence);
  * restart — ``latest_step`` + ``restore`` resume exactly;
  * elastic — restore only reads manifests + npy files, so a different mesh
    can re-shard on load (``distributed/elastic.restore_train_state_elastic``).
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..interop import to_numpy, tree_flatten, tree_map, tree_unflatten

PyTree = Any


def _leaf_paths(tree: PyTree):
    leaves, treedef = tree_flatten(tree)
    return leaves, treedef


def _host(leaf) -> np.ndarray:
    """A leaf as host numpy; a tensor is copied (a CPU tensor too, so the
    result never shares memory that training may write)."""
    if isinstance(leaf, torch.Tensor):
        arr = to_numpy(leaf)
        return arr.copy() if leaf.device.type == "cpu" else arr
    return np.asarray(leaf)


def save_tree_to_store(store, tree: PyTree, offset: int = 0) -> dict:
    """Persist all leaves into a ``BackingStore`` with ONE batched write.

    Leaves are laid out back-to-back from ``offset`` and shipped through
    ``BackingStore.write_from_batch`` — one ``pwritev`` / extent walk /
    latency charge for the whole tree instead of one write per leaf
    (the coalesced write-back pipeline, DESIGN.md §13).  Returns the
    manifest needed by :func:`restore_tree_from_store`.
    """
    leaves, treedef = _leaf_paths(tree)
    bufs, metas = [], []
    pos = offset
    for leaf in leaves:
        arr = np.ascontiguousarray(_host(leaf))
        flat = arr.view(np.uint8).reshape(-1)
        metas.append({"shape": list(arr.shape), "dtype": str(arr.dtype),
                      "nbytes": int(flat.nbytes)})
        bufs.append(flat)
        pos += flat.nbytes
    store.write_from_batch(offset, bufs)
    store.flush()
    return {"treedef": str(treedef), "offset": offset,
            "nbytes": pos - offset, "leaves": metas}


def restore_tree_from_store(store, manifest: dict, like: PyTree) -> PyTree:
    """Restore a :func:`save_tree_to_store` image (ONE batched read)."""
    leaves, treedef = _leaf_paths(like)
    assert len(manifest["leaves"]) == len(leaves), "checkpoint/tree mismatch"
    bufs = [np.empty(m["nbytes"], np.uint8) for m in manifest["leaves"]]
    store.read_into_batch(manifest["offset"], bufs)
    out = [b.view(np.dtype(m["dtype"])).reshape(m["shape"])
           for b, m in zip(bufs, manifest["leaves"])]
    return tree_unflatten(treedef, out)


def save(ckpt_dir: str | Path, step: int, tree: PyTree) -> Path:
    """Synchronous atomic checkpoint save."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:09d}"
    tmp = ckpt_dir / f".tmp_step_{step:09d}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves, treedef = _leaf_paths(tree)
    manifest = {"step": step, "treedef": str(treedef), "leaves": []}
    for i, leaf in enumerate(leaves):
        arr = _host(leaf)
        np.save(tmp / f"leaf_{i:05d}.npy", arr)
        manifest["leaves"].append(
            {"shape": list(arr.shape), "dtype": str(arr.dtype)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    # fsync directory contents then atomic rename
    for f in tmp.iterdir():
        fd = os.open(f, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")]
    return max(steps) if steps else None


def restore(ckpt_dir: str | Path, step: int, like: PyTree) -> PyTree:
    """Restore into the structure of ``like`` (shapes must match)."""
    d = Path(ckpt_dir) / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    leaves, treedef = _leaf_paths(like)
    assert len(manifest["leaves"]) == len(leaves), "checkpoint/tree mismatch"
    out = []
    for i, ref in enumerate(leaves):
        arr = np.load(d / f"leaf_{i:05d}.npy")
        out.append(arr)
    return tree_unflatten(treedef, out)


def restore_arrays(ckpt_dir: str | Path, step: int) -> list:
    """Raw leaf arrays (for elastic resharding without a template tree)."""
    d = Path(ckpt_dir) / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    return [np.load(d / f"leaf_{i:05d}.npy")
            for i in range(len(manifest["leaves"]))]


def gc_old(ckpt_dir: str | Path, keep: int = 3) -> int:
    """Keep the newest ``keep`` checkpoints."""
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(p for p in ckpt_dir.glob("step_*"))
    removed = 0
    for p in steps[:-keep] if keep else steps:
        shutil.rmtree(p)
        removed += 1
    return removed


class AsyncCheckpointer:
    """Watermark-bounded async checkpoint writer (paper §3.5 semantics).

    ``save_async`` enqueues a host copy of the tree and returns immediately.
    If more than ``high_water`` saves are pending, the caller blocks until
    the writer drains to ``low_water`` — bounding dirty (unflushed) steps,
    exactly the UMap evictor-watermark contract.

    With ``store=`` set, writers persist each step into that
    ``BackingStore`` via :func:`save_tree_to_store` — the whole tree as ONE
    batched write (DESIGN.md §13) — instead of one ``.npy`` file per leaf.
    ``tier_fast_bytes=`` additionally wraps the store in a ``TieredStore``
    (DESIGN.md §14) with a host-memory fast tier of that budget and
    ``promote_on_write``: the newest checkpoint image is promoted into the
    fast tier as it is written, so a restore taken shortly after a save (the
    common preemption-recovery path) reads from host memory instead of the
    slow tier, while ``save_tree_to_store``'s flush still pushes every byte
    through to the slow tier for durability.
    Store saves are double-buffered (alternating halves of the store;
    ``save_async`` rejects trees larger than half the store) and
    serialized across writer threads, and ``store_manifest`` is published
    only after the slot is fully written+flushed — the store-mode
    analogue of the file path's tmp-dir + rename atomic publish: a crash
    mid-save leaves the previously published image intact.  Note the
    two-slot history window: a restore that overlaps TWO subsequent
    completed saves has its slot rewritten mid-read, so pause saves (or
    ``flush`` first) around restores taken from a live checkpointer.
    """

    def __init__(self, ckpt_dir: str | Path, writers: int = 1,
                 high_water: int = 2, low_water: int = 1, keep: int = 3,
                 store=None, tier_fast_bytes: int = 0):
        self.ckpt_dir = Path(ckpt_dir)
        self.high_water = high_water
        self.low_water = low_water
        self.keep = keep
        if store is not None and tier_fast_bytes > 0:
            from ..core.store import HostArrayStore, TieredStore
            if not isinstance(store, TieredStore):
                store = TieredStore(
                    HostArrayStore(np.zeros(tier_fast_bytes, np.uint8)),
                    store, fast_bytes=tier_fast_bytes,
                    extent_size=min(1 << 20, tier_fast_bytes),
                    promote_on_write=True)
        self.store = store
        self.store_manifest: Optional[dict] = None
        self._store_lock = threading.Lock()    # serialize store-mode saves
        self._store_slot = 0                   # double-buffer slot toggle
        self._q: "queue.Queue" = queue.Queue()
        self._pending = 0
        self._lock = threading.Lock()
        self._drained = threading.Condition(self._lock)
        self._stop = object()
        self._threads = [
            threading.Thread(target=self._writer, daemon=True,
                             name=f"ckpt-evictor-{i}")
            for i in range(writers)
        ]
        for t in self._threads:
            t.start()
        self.stats = {"saves": 0, "blocked_on_watermark": 0}

    def save_async(self, step: int, tree: PyTree) -> None:
        # Every leaf is copied to host numpy here, before this returns, so
        # the writer thread never reads a tensor that training mutates.
        # Leaves exposing `snapshot_tree()` (pager-backed state: PagedTree /
        # PagedOptimizerState, DESIGN.md §18.4) are materialized through it
        # — a consistent-snapshot read that BLOCKS on in-flight write leases
        # — instead of a plain copy, which could copy mid-mutation bytes.
        # (Such objects are leaves of `tree_flatten`: neither dict, list
        # nor tuple.)
        host_tree = tree_map(
            lambda a: (tree_map(_host, a.snapshot_tree())
                       if hasattr(a, "snapshot_tree") else _host(a)), tree)
        if self.store is not None:
            # Fail fast on the caller: an image larger than one slot would
            # overwrite the other slot's published bytes (or be silently
            # truncated by clamping stores).
            nbytes = sum(a.nbytes for a in tree_flatten(host_tree)[0])
            if nbytes > self.store.size // 2:
                raise ValueError(
                    f"checkpoint image of {nbytes} bytes exceeds the "
                    f"double-buffer slot ({self.store.size // 2} bytes); "
                    f"use a larger store")
        with self._lock:
            if self._pending >= self.high_water:
                self.stats["blocked_on_watermark"] += 1
                while self._pending > self.low_water:
                    self._drained.wait()
            self._pending += 1
        self._q.put((step, host_tree))

    def _free_fast_tier(self) -> None:
        """Demote every resident fast-tier extent before a save (tiered
        store mode only).

        This checkpointer owns its (engine-less) ``TieredStore``, so the
        PREVIOUS save's extents would otherwise hold the fast tier forever
        and ``promote_on_write`` — the 'newest image restores from host
        memory' promise — would find no free slots after the first save.
        Every resident extent is clean post-flush (``save_tree_to_store``
        flushes), so demotion is a pure metadata flip; the previous
        image's durability lives in the slow tier, and a restore taken
        *inside* the save window reads it from there (the documented
        two-slot overlap caveat) — the promise applies between saves.
        """
        from ..core.store import TierChain
        if not isinstance(self.store, TierChain):
            return
        exts = set()
        for lvl in range(self.store.base_level):
            exts.update(self.store.resident_extents(lvl))
        for ext in exts:
            while self.store.demote(ext):      # drop every cache-level copy
                pass

    def _writer(self) -> None:
        while True:
            item = self._q.get()
            if item is self._stop:
                return
            step, tree = item
            if self.store is not None:
                with self._store_lock:
                    # Write into the half NOT referenced by the published
                    # manifest, then publish — the previous image stays
                    # intact until the new one is durable.
                    offset = self._store_slot * (self.store.size // 2)
                    self._store_slot ^= 1
                    self._free_fast_tier()
                    manifest = save_tree_to_store(self.store, tree,
                                                  offset=offset)
                    manifest["step"] = step
                    with self._lock:
                        self.store_manifest = manifest
            else:
                save(self.ckpt_dir, step, tree)
                gc_old(self.ckpt_dir, self.keep)
            with self._lock:
                self._pending -= 1
                self.stats["saves"] += 1
                self._drained.notify_all()

    def flush(self, timeout: float = 60.0) -> None:
        """Block until all queued checkpoints are durable (preemption path)."""
        deadline = time.time() + timeout
        with self._lock:
            while self._pending > 0 and time.time() < deadline:
                self._drained.wait(timeout=0.1)

    def close(self) -> None:
        self.flush()
        for _ in self._threads:
            self._q.put(self._stop)
        for t in self._threads:
            t.join(timeout=5)
