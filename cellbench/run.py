#!/usr/bin/env python3
"""Run one cell of the port's serving benchmark.

    python3 cellbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; ``checks`` last, each number compared beside its limit,
which also close standard error.  Exits non-zero, printing no result,
without a card (or with fewer than the cell asks for), or where the JAX
side (``jax``, ``jaxlib``, ``flax``, ``repro``) is loaded once the window
has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "cellbench"


def _paths() -> None:
    """The checkout's root and its ``src`` first; this script's own folder
    not at all (its modules would shadow the standard library's)."""
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(here)]
    sys.path[0:0] = [str(ROOT), str(ROOT / "src")]


def _environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout; one
    host thread for CPU math (the host is shared, and the engine's host work
    is one thread's)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv_compute_cache")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    _environment()
    import torch

    torch.set_num_threads(1)

    from cellbench.bench import Bench
    from cellbench.cell import forbidden_modules, run_cell

    bench = Bench(ROOT)
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cellbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 3
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_start=T_START)
    out.pop("window", None)
    found = forbidden_modules()
    if found:
        print(f"cellbench: the JAX side is loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        bound = c.get("limit", c.get("min"))
        print(f"check {name} {c['value']!r} {'limit' if 'limit' in c else 'min'} {bound!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
