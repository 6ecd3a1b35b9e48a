"""PyTorch port: its copies of the UMap paging core, of telemetry and of
the data pipeline.

``repro_torch/core/**``, ``repro_torch/telemetry/**`` and
``repro_torch/data/pipeline.py`` are whole-file copies of the JAX package's pure-Python modules (the port imports nothing of
``repro``).  Each must equal its source up to the package name, and the
copies must page the same bytes as the reference: the same store read
through a region, leased, and tiered, gives the same bytes and counters.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import repro.core as RC
import repro_torch.core as TC

SRC = Path(__file__).resolve().parents[1] / "src"
CORE = ["__init__", "buffer", "config", "hints", "lease", "pager", "pagetable", "pattern",
        "region", "resilient", "store", "watermark"]
TELEMETRY = ["__init__", "exporter", "metrics", "registry"]
COLLECTORS = ["__init__", "base", "leases", "pager", "process", "resilience", "serve",
              "tiering", "train"]
COPIES = ([f"core/{n}.py" for n in CORE] + [f"telemetry/{n}.py" for n in TELEMETRY]
          + [f"telemetry/collectors/{n}.py" for n in COLLECTORS] + ["data/pipeline.py"])


@pytest.mark.parametrize("path", COPIES)
def test_copy_equals_its_reference_up_to_the_package_name(path):
    ref = (SRC / "repro" / path).read_text()
    got = (SRC / "repro_torch" / path).read_text()
    assert got == re.sub(r"\brepro\b(?!_)", "repro_torch", ref)


def test_every_reference_module_of_core_and_telemetry_is_copied():
    for pkg in ("core", "telemetry", "telemetry/collectors"):
        names = {p.name for p in (SRC / "repro" / pkg).glob("*.py")}
        assert {p.name for p in (SRC / "repro_torch" / pkg).glob("*.py")} == names, pkg


def pattern_bytes(npages, ps):
    return (np.arange(npages * ps) % 251).astype(np.uint8)


@pytest.mark.parametrize("zero_copy", [True, False])
def test_region_reads_and_leases_match_the_reference(zero_copy):
    """The same store through both packages' regions: reads, a lease run and
    a write-back give the same bytes and the same lease counters."""
    ps, npages = 1024, 32
    outs = []
    for core in (RC, TC):
        region = core.umap(core.HostArrayStore(pattern_bytes(npages, ps)),
                           config=core.UMapConfig(page_size=ps, buffer_size=8 * ps,
                                                  num_fillers=2, num_evictors=1,
                                                  zero_copy_leases=zero_copy))
        try:
            got = [region.read(3 * ps + 17, 5 * ps).copy()]
            with region.lease_run(10, 3) as run:
                got += [np.array(v) for v in run.views]
            region.write(20 * ps + 5, np.full(100, 7, np.uint8))
            region.flush()
            got.append(region.read(20 * ps, ps).copy())
            st = region.stats()
            outs.append((got, st["leases"]))
        finally:
            core.uunmap(region)
    (ref, ref_leases), (port, port_leases) = outs
    assert port_leases == ref_leases == 3
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)


def test_tiered_pin_fast_matches_the_reference():
    """A TieredStore region pins the same extents fast in both packages."""
    ps, ext = 4096, 4 * 4096
    pinned = []
    for core in (RC, TC):
        ts = core.TieredStore(core.HostArrayStore(np.zeros(4 * ext, np.uint8)),
                              core.HostArrayStore(pattern_bytes(32, ps)), extent_size=ext,
                              promote_on_read=False)
        region = core.umap(ts, config=core.UMapConfig(page_size=ps, buffer_size=16 * ps))
        try:
            region.advise(tier_hint="pin_fast", offset=ext, nbytes=2 * ext)
            region.flush()
            pinned.append(sorted(ts.pinned_fast_extents()))
            np.testing.assert_array_equal(region.read(ext, ps), pattern_bytes(32, ps)[ext:ext + ps])
        finally:
            core.uunmap(region)
    assert pinned[0] == pinned[1] == [1, 2]
