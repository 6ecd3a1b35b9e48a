"""Quickstart: UMap regions in five minutes (port of the JAX package's
``examples/quickstart.py``).

Creates a disk-backed region, demonstrates demand paging, app-driven
prefetch, dirty watermark flushing, and the page-size advisor — the paper's
API surface end to end.  Host only: the paging core uses no device.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""

from __future__ import annotations

import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

from ..core import (
    FileStore,
    PageSizeAdvisor,
    StoreProfile,
    UMapConfig,
    WorkloadProfile,
    umap,
    uunmap,
)


def run(tmp: Path) -> dict:
    """The walk-through on a file under ``tmp``; returns the region's stats
    (without the per-filler counts) and the advised page size."""
    path = tmp / "data.bin"

    # 1. a 64 MiB file on disk, far bigger than the page buffer we'll allow
    n = 8 * 1024 * 1024
    np.arange(n, dtype=np.int64).tofile(path)
    store = FileStore(str(path))

    # 2. map it with an 8 MiB buffer of 256 KiB UMap pages (umap() ~ mmap())
    cfg = UMapConfig(page_size=256 * 1024, buffer_size=8 * 1024 * 1024,
                     num_fillers=4, num_evictors=2, read_ahead=2)
    region = umap(store, config=cfg)

    # 3. demand paging: read anywhere; the pager faults pages in
    view = region.view(np.int64)
    assert view[12345] == 12345
    assert list(view[1_000_000:1_000_004]) == [1_000_000, 1_000_001,
                                               1_000_002, 1_000_003]

    # 4. app-driven prefetch of an arbitrary page set (paper §3.6)
    region.prefetch_pages([3, 99, 7, 150])

    # 5. writes mark pages dirty; the watermark monitor flushes in background
    view[0:4] = np.array([9, 8, 7, 6], np.int64)
    region.flush()
    check = np.fromfile(path, np.int64, count=4)
    assert list(check) == [9, 8, 7, 6]

    stats = {k: v for k, v in region.stats().items() if k != "per_filler_fills"}

    # 6. page-size advisor: napkin math the paper's central knob
    advisor = PageSizeAdvisor(
        StoreProfile.nvme(),
        WorkloadProfile(useful_bytes_per_access=8, locality_bytes=1 << 20))
    advised = advisor.recommend()

    uunmap(region)
    store.close()
    return {"stats": stats, "advised_page_size": advised}


def main(argv=None) -> int:
    del argv
    tmp = Path(tempfile.mkdtemp(prefix="umap_quickstart_"))
    try:
        out = run(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("stats:", out["stats"])
    print("advised page size for sequential-ish NVMe workload:",
          out["advised_page_size"] // 1024, "KiB")
    print("quickstart OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
