"""Shared by the cellbench CPU tests: a temporary checkout root holding a
copy of ``cellbench/`` with the smoke configurations, traffic mixes and
limits added as new files, and a ``BENCHMARK.json`` naming only them.
Both smoke cells take ``smoke/limits/smoke.json``; :func:`hold_to` puts
a cell of the repo's numbers in its place."""

from __future__ import annotations

import functools
import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SMOKE = Path(__file__).resolve().parent / "smoke"
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

OPEN, SAT = "deepseek-smoke.smoke-open", "mixtral-smoke.smoke-sat"
CELLS = {OPEN: ("deepseek-smoke", "smoke-open"), SAT: ("mixtral-smoke", "smoke-sat")}


def smoke_root(tmp: Path, extra_metric: str = None) -> Path:
    """A checkout root in ``tmp``: the smoke cells added to a copy of
    ``cellbench/`` as new files only (configs, traffic, limits, and
    optionally one new metric reader), and a BENCHMARK.json of them."""
    root = Path(tmp) / "root"
    shutil.copytree(REPO / "cellbench", root / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for sub in ("configs", "traffic"):
        for f in (SMOKE / sub).iterdir():
            assert not (root / "cellbench" / sub / f.name).exists()
            shutil.copy(f, root / "cellbench" / sub / f.name)
    for cell in CELLS:
        shutil.copy(SMOKE / "limits" / "smoke.json", root / "cellbench" / "limits" / f"{cell}.json")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": c, "source": "smoke", "file": f"cellbench/configs/{c}.json",
                        "reduced": [], "why": "smoke"} for c in ("deepseek-smoke", "mixtral-smoke")]
    spec["workloads"] = [{"name": k, "config": c, "traffic": t, "chips": 1, "why": "smoke"}
                         for k, (c, t) in CELLS.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({OPEN if w.startswith("deepseek") else SAT
                                     for w in m["workloads"]})
    if extra_metric:
        spec["per_layer"].append({"name": extra_metric, "unit": "tokens", "better": "higher",
                                  "source": "program_counter", "layer": "engine",
                                  "moves": "itl_p99_ms"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def hold_to(root: Path, smoke_cell: str, cell: str) -> None:
    """Hold a smoke cell to the numbers another cell compares, each at the
    smoke's float32 limit."""
    lim = json.loads((REPO / "cellbench" / "limits" / f"{cell}.json").read_text())
    smoke = json.loads((SMOKE / "limits" / "smoke.json").read_text())
    (root / "cellbench" / "limits" / f"{smoke_cell}.json").write_text(json.dumps({
        "compare": {k: smoke["compare"]["logit_gap"] for k in lim["compare"]},
        "min_tokens": smoke["min_tokens"]}))


class SimClock:
    """A host clock that moves 4 ms a reading (and a sleep's length): the
    smoke window does the same work however loaded the test host is."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 0.004
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


def run_smoke(root: Path, cell: str, seed: int = 987654321987, seconds: float = 1.5,
              trace: bool = False, control: bool = False) -> dict:
    from unittest import mock

    from cellbench import drive
    from cellbench.bench import Bench
    from cellbench.cell import run_cell

    import torch

    clock = SimClock()
    window = functools.partial(drive.run_window, clock=clock, sleep=clock.sleep)
    # one CPU thread: the smoke model's ops are tiny, and a pool of threads
    # in each of several test workers spins against the others
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with mock.patch.object(drive, "run_window", window):
            return run_cell(Bench(root), cell, seed, seconds, trace=trace, device="cpu",
                            control=control)
    finally:
        torch.set_num_threads(threads)
