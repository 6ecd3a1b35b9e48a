"""The paper's flagship workload as a standalone example: umapsort (port of
the JAX package's ``examples/out_of_core_sort.py``).

Sorts a disk file far larger than the permitted page buffer, comparing the
mmap-semantics baseline against UMap with the paper's recommended large-page
configuration — then prints the observed speedup (paper Fig 2: 2.5x at 8 MiB
pages on NVMe).  Host only: the paging core uses no device, so the times
are the host's.

Run:  PYTHONPATH=src python -m repro_torch.examples.out_of_core_sort [--mb 64]
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from ..core import FileStore, UMapConfig, umap, uunmap

ITEM = 8  # int64


# _make_dataset and _sort_through_region: copies of the JAX package's
# benchmarks/bench_sort.py (the port imports nothing of it); the merge also
# returns what it merged
def _make_dataset(path: Path, n_bytes: int) -> None:
    if path.exists() and path.stat().st_size == n_bytes:
        return
    rng = np.random.default_rng(0)
    n = n_bytes // ITEM
    # the paper uses an ascending sequence sorted into descending order;
    # shuffle instead so every run does real work
    arr = rng.permutation(n).astype(np.int64)
    path.parent.mkdir(parents=True, exist_ok=True)
    arr.tofile(path)


def _sort_through_region(src: Path, cfg: UMapConfig, n_bytes: int,
                         threads: int = 4) -> dict:
    """Phase 1 sorts buffer-sized runs in place, descending; phase 2 merges
    them in a streaming pass.  Returns the merge's bytes and the sum of the
    values it merged."""
    run_bytes = cfg.buffer_size // 2            # in-memory run size
    n_runs = -(-n_bytes // run_bytes)
    store = FileStore(str(src))
    region = umap(store, config=cfg)
    try:
        # phase 1: sort runs in place (parallel fillers serve the reads)
        def sort_run(i):
            lo = i * run_bytes
            hi = min(n_bytes, lo + run_bytes)
            blob = region.read(lo, hi - lo)
            vals = np.sort(blob.view(np.int64))[::-1]   # descending (paper)
            region.write(lo, np.ascontiguousarray(vals).view(np.uint8))

        with cf.ThreadPoolExecutor(threads) as ex:
            list(ex.map(sort_run, range(n_runs)))
        region.flush()

        # phase 2: streaming k-way merge (read-only over the sorted runs)
        heads = [i * run_bytes for i in range(n_runs)]
        ends = [min(n_bytes, (i + 1) * run_bytes) for i in range(n_runs)]
        chunk = max(cfg.page_size, 256 * 1024)
        bufs = [None] * n_runs
        offs = [0] * n_runs

        def refill(i):
            take = min(chunk, ends[i] - heads[i])
            if take <= 0:
                bufs[i] = np.empty(0, np.int64)
                return
            bufs[i] = region.read(heads[i], take).view(np.int64)
            heads[i] += take
            offs[i] = 0

        for i in range(n_runs):
            refill(i)
        merged = 0
        merged_sum = 0
        # coarse merge: repeatedly take the run with the largest head value
        # in block steps (exact ordering is irrelevant to the I/O pattern)
        while merged < n_bytes:
            best, best_v = -1, None
            for i in range(n_runs):
                if offs[i] < len(bufs[i]):
                    v = bufs[i][offs[i]]
                    if best_v is None or v > best_v:
                        best, best_v = i, v
            if best < 0:
                break
            take = len(bufs[best]) - offs[best]
            merged_sum += int(bufs[best][offs[best]:].sum())
            offs[best] += take
            merged += take * ITEM
            if offs[best] >= len(bufs[best]):
                refill(best)
    finally:
        uunmap(region)
        store.close()
    return {"merged_bytes": merged, "merged_sum": merged_sum}


def configs(buffer: int) -> dict:
    """The two configurations the example compares, by name."""
    return {
        "mmap (4K pages, sync faults)": UMapConfig.mmap_baseline(buffer),
        "umap (1M pages, 8 fillers)": UMapConfig(
            page_size=1024 * 1024, buffer_size=buffer, num_fillers=8,
            num_evictors=4, read_ahead=2),
    }


def run(src: Path, n_bytes: int, buffer: int) -> dict:
    """Each configuration sorts a fresh dataset at ``src`` (the JAX
    package's example sorts the first sort's output again in the second
    configuration, whose runs are then sorted already); returns the seconds
    and the merge's result by name (the file holds the last sort)."""
    out = {}
    for name, cfg in configs(buffer).items():
        if src.exists():
            src.unlink()
        _make_dataset(src, n_bytes)
        t0 = time.perf_counter()
        merge = _sort_through_region(src, cfg, n_bytes)
        out[name] = {"seconds": time.perf_counter() - t0, **merge}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=64)
    ap.add_argument("--buffer-mb", type=int, default=16)
    args = ap.parse_args(argv)

    tmp = Path(tempfile.mkdtemp(prefix="umapsort_"))
    try:
        src = tmp / "data.bin"
        n_bytes = args.mb * 1024 * 1024
        buffer = args.buffer_mb * 1024 * 1024
        results = run(src, n_bytes, buffer)
        for name, r in results.items():
            print(f"{name:34s} {r['seconds']:7.2f}s")
        base, tuned = (r["seconds"] for r in results.values())
        print(f"\nUMap speedup over mmap baseline: {base / tuned:.2f}x "
              f"(paper Fig 2: 2.5x)")
        # verify sortedness of the first run region
        arr = np.fromfile(src, np.int64, count=min(n_bytes // 8, 1 << 20))
        runs_desc = np.all(np.diff(arr[: buffer // 16]) <= 0)
        print("first run descending:", bool(runs_desc))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
