"""Split-size sweep of the ``paged_attention`` kernel on one CUDA card.

    PYTHONPATH=src python -m repro_torch.kernels.paged_attention.sweep

At ``chip_smoke.py``'s three decode shapes (smollm-135m serving, smollm at
a 2048-token context, qwen2-1.5b at 1.8-3.6 k tokens) and at llama3-8b's
(8 sequences x 8 KV heads at 4096 tokens, where :func:`split_plan`'s
blocks-per-SM rule, not its 128-token floor, sets the split), the kernel
runs with fixed pages per split beside the plan's own.  Each run is held
against the plain version (per output row, 1e-2 bf16 / 2e-5 fp32 of the
row's norm) and prints one JSON line: device ms of one call (CUDA events
around device work only, L2 flushed before each call, median of 30), the
split and merge kernels' device us per call from ``torch.profiler``, and
the wrapper's host us per call (100 calls enqueued behind a spin kernel).
Then the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from . import kernel as kmod
from .ref import paged_attention_ref

SPIN_CYCLES = 10_000_000            # >= 5 ms at the H100's <= 1.98 GHz clock
ROW_REL_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# H, num_heads, KVH, D, B, pool pages, pages per sequence, lengths
CASES = {
    "serve": (16, 9, 3, 64, 8, 512, 32,
              [int(x) for x in np.random.default_rng(0).integers(4, 41, size=8)]),
    "ctx2048": (16, 9, 3, 64, 8, 1025, 128, [2048] * 8),
    "qwen2_decode": (16, 12, 2, 128, 4, 1408, 264, [3637, 2981, 2594, 1853]),
    "llama3_8b_4096": (32, 32, 8, 128, 8, 2049, 256, [4096] * 8),
}
PAGES_PER_SPLIT = (1, 2, 4, 8, 16, 32, 64)
PAGE = 16


def inputs(rng, dtype, h, kvh, d, b, pages, pps, lengths):
    dt = getattr(torch, dtype)
    q, kp, vp = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to("cuda", dt)
                 for s in ((b, h, d), (pages, PAGE, kvh, d), (pages, PAGE, kvh, d)))
    table = np.stack([rng.choice(np.arange(1, pages), size=pps, replace=False)
                      for _ in range(b)]).astype(np.int32)
    return (q, kp, vp, torch.from_numpy(table).cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def device_ms(fn, flush, reps=30, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def kernel_us(fn, flush, reps=10):
    """Device us per call of the split and the merge kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        for part in ("split", "merge"):
            if f"paged_attention_{part}_kernel" in e.key:
                out[part] = out.get(part, 0.0) + us / reps
    return out


def host_us(fn, calls=100):
    torch.cuda.synchronize()
    torch.cuda._sleep(20 * SPIN_CYCLES)              # the queue never drains meanwhile
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def row_rel_err(out, ref):
    diff = (out.float() - ref.float()).norm(dim=-1)
    norm = ref.float().norm(dim=-1)
    live = norm > 0
    assert bool((diff[~live] == 0).all()), "a zero row of the plain version is not zero"
    return (diff[live] / norm[live]).max().item()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("sweep: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    planned = kmod.split_plan
    sms = kmod._num_sms(torch.device("cuda"))
    try:
        for case, (h, nh, kvh, d, b, pages, pps, lengths) in CASES.items():
            plan = planned(pps, PAGE, b, kvh, sms)[0]
            for dtype in ("bfloat16", "float32"):
                args = inputs(rng, dtype, h, kvh, d, b, pages, pps, lengths)
                ref = paged_attention_ref(*args, num_heads=nh)
                for per in sorted({p for p in PAGES_PER_SPLIT if p < pps} | {pps, plan}):
                    kmod.split_plan = (lambda _p, *_, per=per: (per, -(-_p // per)))
                    run = lambda: kmod.paged_attention(*args, num_heads=nh)    # noqa: E731
                    err = row_rel_err(run()[:, :nh], ref[:, :nh])
                    if err > ROW_REL_TOL[dtype]:
                        raise AssertionError(f"{case} {dtype} per {per}: row error {err}")
                    print(json.dumps({
                        "case": case, "dtype": dtype, "pages_per_split": per,
                        "splits": -(-pps // per), "planned": per == plan,
                        "ms": device_ms(run, flush), "kernel_us": kernel_us(run, flush),
                        "host_us": host_us(run), "max_row_rel_err": err}), flush=True)
                    kmod.split_plan = planned
    finally:
        kmod.split_plan = planned
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
