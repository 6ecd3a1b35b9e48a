"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``.

Port of ``repro/launch/serve.py``: continuous batching over the paged KV
cache (serve/engine.py) with a synthetic request stream; prints throughput
and pool telemetry.  Runs on the card by default; ``--device cpu`` runs the
plain PyTorch path (``--smoke`` picks the reduced config).  Weights are
random, from ``--seed``.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --smoke --device cpu --requests 4 --max-new 4
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=512)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--deadline-s", type=float, default=120.0)
    args = ap.parse_args(argv)

    from .. import models as M
    from ..configs.registry import get_config, get_smoke_config
    from ..serve.engine import EngineConfig, Request, ServeEngine

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.input_mode != "tokens" or cfg.is_encdec:
        print(f"{args.arch}: engine demo targets decoder-only token models",
              file=sys.stderr)
        return 2
    params = M.init_params(cfg, args.seed, device=args.device)
    eng = ServeEngine(cfg, params, EngineConfig(
        max_batch=args.max_batch, page_size=args.page_size,
        num_pages=args.num_pages,
        max_pages_per_seq=max(32, (args.max_new + 64) // args.page_size + 4),
        prefill_bucket=32), device=args.device)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for rid in range(args.requests):
        L = int(rng.integers(4, 24))
        eng.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, size=L).astype(np.int32),
            max_new_tokens=args.max_new, deadline_s=args.deadline_s))
    eng.run_until_drained(max_steps=50_000)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0
    toks = sum(len(r.generated) for r in eng.finished)
    print(f"served {len(eng.finished)}/{args.requests} requests, "
          f"{toks} tokens in {dt:.2f}s ({toks / max(dt, 1e-9):.1f} tok/s) "
          f"on {eng.device}")
    print("engine:", eng.stats)
    print(f"pool: {eng.allocator.used_pages}/{eng.allocator.num_pages} pages "
          f"({args.page_size} tokens/page)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
