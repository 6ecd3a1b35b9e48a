"""Serving driver: continuous batching over the paged KV cache (port of the
JAX package's ``examples/serve_paged.py``).

Demonstrates the full UMap-at-the-KV-level story: page-pool allocation
(free-list), admission watermarks on pool occupancy, per-sequence page
tables driving the decode step, sliding-window page eviction accounting,
and straggler requeue — while generating real tokens from a reduced
SmolLM-family model and cross-checking a sample against unbatched decode.
Runs on the card by default (``paged_attention`` and ``page_gather`` /
``page_scatter`` are its kernels); ``--device cpu`` runs the plain PyTorch
path.  Weights are random, from ``--seed``.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_paged [--requests 12]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import models as M
from ..configs.registry import get_smoke_config
from ..serve.engine import EngineConfig, Request, ServeEngine


def engine_config(page_size: int) -> EngineConfig:
    return EngineConfig(max_batch=4, page_size=page_size, num_pages=256,
                        max_pages_per_seq=32, prefill_bucket=16,
                        admit_high_water=0.85, admit_low_water=0.60)


def requests(cfg, n: int, max_new: int, seed: int = 0) -> list:
    """``n`` requests with prompts of 4-13 tokens (numpy ``seed``)."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        L = int(rng.integers(4, 14))
        out.append(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, size=L).astype(np.int32),
            max_new_tokens=max_new,
            deadline_s=30.0))
    return out


def serve(cfg, params, reqs: list, page_size: int, device) -> tuple:
    """The engine over ``reqs`` until drained: (engine, seconds)."""
    eng = ServeEngine(cfg, params, engine_config(page_size), device=device)
    t0 = time.time()
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=2000)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return eng, time.time() - t0


def contiguous_decode(cfg, params, prompt, max_new: int, device) -> list:
    """Unbatched greedy decode of ``prompt`` through a contiguous cache."""
    toks_ref = [int(t) for t in prompt]
    cache = M.init_cache(cfg, 1, 128, device=device)

    def tensor(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    _, cache = M.prefill(cfg, params, {"tokens": tensor([toks_ref[:-1]])}, cache)
    cur = len(toks_ref) - 1
    out = []
    for _ in range(max_new):
        logits, cache = M.decode_step(cfg, params, cache, tensor([toks_ref[-1]]),
                                      tensor([cur]))
        nxt = int(logits[0].argmax())
        out.append(nxt)
        toks_ref.append(nxt)
        cur += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke_config("smollm-135m")
    params = M.init_params(cfg, args.seed, device=args.device)
    eng, dt = serve(cfg, params, requests(cfg, args.requests, args.max_new),
                    args.page_size, args.device)

    done = len(eng.finished)
    toks = sum(len(r.generated) for r in eng.finished)
    print(f"served {done}/{args.requests} requests, {toks} tokens "
          f"in {dt:.2f}s ({toks / dt:.1f} tok/s)")
    print("engine stats:", eng.stats)
    print(f"pool: {eng.allocator.used_pages} used / "
          f"{eng.allocator.num_pages} pages "
          f"(page = {args.page_size} tokens)")

    # cross-check one request against unbatched decode
    req = eng.finished[0]
    out = contiguous_decode(cfg, eng.params, req.prompt, args.max_new, eng.device)
    assert out == req.generated, "batched paged decode diverged from reference"
    print("paged-decode cross-check OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
