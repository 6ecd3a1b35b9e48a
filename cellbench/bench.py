"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<config>.json``, the entry's ``file``), its
traffic mix (``traffic/<traffic>.json``), its correctness limits
(``limits/<cell>.json``) and each metric's reader
(``metrics/<metric>.py``, a ``read(run)`` that returns a number, or None
where it finds nothing to read).  A metric split by the end-to-end
metric it moves (``<quantity>.<mix>``) shares the reader of its quantity,
``metrics/<quantity>.py``, where no file of its own name is there."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

class Bench:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.here = self.root / "cellbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def mix(self, name: str) -> dict:
        return json.loads((self.here / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.here / "limits" / f"{workload}.json").read_text())

    def metrics(self, workload: str, traced: bool) -> List[dict]:
        """The cell's end-to-end metrics (untraced) or per-layer metrics
        (traced), setup_s left to the harness."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.spec[key] if m["name"] != "setup_s"
                and workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> Callable:
        path = self.here / "metrics" / f"{metric}.py"
        if not path.exists() and "." in metric:
            path = self.here / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
        spec = importlib.util.spec_from_file_location(
            "cellbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def read_metrics(bench: Bench, workload: str, traced: bool, run) -> Dict[str, dict]:
    out = {}
    for m in bench.metrics(workload, traced):
        value = bench.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
