#!/usr/bin/env python3
"""Find the knee of an open-loop cell: the highest offered rate at which
the engine's waiting queue does not grow over the window.

    python3 cellbench/sweep.py --workload deepseek-7b.unshared --seed <n> \\
        --seconds 30 --rates 3,4,5,6,7

One process; each rate runs the cell's traffic at that rate through a
fresh engine (the cell's own set-up), and prints one JSON line: the
waiting queue's mean over each quarter of the window, requests arrived
and finished, tokens/s, the tails, the engine's admission pauses.  Not
part of a benchmark run: a cell's rate is fixed in its traffic file.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]
ROOT = Path(__file__).resolve().parents[1]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    import torch

    from cellbench import drive
    from cellbench.bench import Bench
    from cellbench.cell import run_cell

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 3
    bench = Bench(ROOT)
    base = bench.mix(bench.workload(args.workload)["traffic"])
    for rate in (float(r) for r in args.rates.split(",")):
        arrivals = {**base["arrivals"], "rate_per_s": rate}
        out = run_cell(bench, args.workload, args.seed, args.seconds, trace=False,
                       mix_override={"arrivals": arrivals})
        w = out.pop("window")
        quarters = []
        for q in range(4):
            lo, hi = q * w.seconds / 4, (q + 1) * w.seconds / 4
            arrived = [r.item.due_s for r in w.reqs if r.in_window and r.submit_s is not None]
            # requests arrived but not yet admitted, sampled at each step's start
            waits = []
            for s in w.steps:
                if lo <= s.t0 < hi:
                    admitted_by = {rid for st in w.steps if st.t1 <= s.t0 for rid in st.admitted}
                    waits.append(sum(1 for r in w.reqs if r.in_window and r.submit_s is not None
                                     and r.submit_s <= s.t0 and r.item.rid not in admitted_by))
            quarters.append(sum(waits) / len(waits) if waits else None)
        ttft, itl = drive.ttft_ms(w), drive.itl_ms(w)
        print(json.dumps({
            "rate_per_s": rate, "arrived": len(arrived),
            "finished": sum(1 for r in w.reqs if r.req is not None and r.req.finished_at is not None),
            "out_tok_s": drive.out_tokens(w) / w.seconds,
            "waiting_by_quarter": quarters,
            "ttft_p50_ms": drive.quantile(ttft, 0.5), "ttft_p95_ms": drive.quantile(ttft, 0.95),
            "itl_p50_ms": drive.quantile(itl, 0.5), "itl_p99_ms": drive.quantile(itl, 0.99),
            "admission_pauses": w.stats1["admission_pauses"] - w.stats0["admission_pauses"],
            "evictions": w.stats1["evictions"] - w.stats0["evictions"],
            "peak_pages_used": w.stats1["peak_pages_used"], "num_pages": out["info"]["pool"]["num_pages"],
            "correct": out["correct"], "gaps": out["info"]["gaps"],
            "setup_s": out["metrics"]["setup_s"]["value"]}), flush=True)
        del w, out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
