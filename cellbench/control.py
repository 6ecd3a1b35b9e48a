#!/usr/bin/env python3
"""Readings that set a cell's correctness limit (``limits/<cell>.json``).

    python3 cellbench/control.py --workload <cell> --seeds a,b,... \\
        --control-seeds a,b,c --seconds 51 [--witness]

One process.  For each seed, a run of the cell at its own load and sizes
and the check as ``run.py`` makes it: the program's readings.  On the
control seeds also the float8 control's at the same positions
(``reference/quant.py``), held to the cell's limits by the same code: it
has to come out not correct.  ``--witness`` (a cell with experts) also
reads both under other routings of the reference (``check.judge``): with
the router's logits rounded to bfloat16, and following near-tied routes
taken the other way.  Prints one JSON line a seed and a summary: the program's
largest reading of each number (the lower end) and the control's
smallest (the upper end).
"""

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]
ROOT = Path(__file__).resolve().parents[1]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]


# references a witness reads the served tokens under (each set judges a
# token by the best of its references): the plain float32 routing, the
# router's logits rounded to bfloat16, and near-tied routes followed the
# other way at two margins
WITNESS = {"fp32_route": [{}], "bf16_route": [{"router_dtype": "bfloat16"}],
           **{f"flip_{t:g}": [{"flip_margin": t}] for t in (0.03, 0.1)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--witness", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from cellbench.bench import Bench
    from cellbench.cell import run_cell

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    bench = Bench(ROOT)
    witness = WITNESS if args.witness else None
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    program, control = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(bench, args.workload, seed, args.seconds, trace=False,
                       control=seed in ctl, witness=witness)
        out.pop("window")
        program.append(out["info"]["gaps"])
        if seed in ctl:
            control.append(out["control"]["gaps"])
        info = out["info"]
        print(json.dumps({"seed": seed, "correct": out["correct"], "program": info["gaps"],
                          "control": out.get("control"), "witness": out.get("witness"),
                          "tokens_checked": out["checks"]["tokens_checked"]["value"],
                          "requests_checked": info["requests_checked"],
                          "reference_s": info["reference_s"],
                          "memory_peak_bytes": out["device"]["memory_peak_bytes"],
                          "memory_in_use_bytes": info["memory_in_use_bytes"],
                          "peak_pages_used": info["peak_pages_used"],
                          "num_pages": info["pool"]["num_pages"],
                          "attempted": out["attempted"],
                          "metrics": out["metrics"]}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    names = sorted(program[0]) if program else []
    print(json.dumps({"workload": args.workload,
                      "program_max": {k: max(p[k] for p in program) for k in names},
                      "control_min": {k: min(c[k] for c in control) for k in names} if control
                      else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
