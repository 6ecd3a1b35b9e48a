"""Arithmetic the metric readers (``metrics/<name>.py``) share.  Each
returns None where its run has nothing to read."""

from __future__ import annotations

from typing import List, Optional

from . import costs
from .drive import quantile, ttft_pairs


def admitted(run) -> List:
    """Every admission (a prefill) in the window, with its request's
    record; a request admitted twice (evicted, restarted) counts twice."""
    by_rid = {r.item.rid: r for r in run.window.reqs}
    return [by_rid[rid] for s in run.window.steps for rid in s.admitted if rid in by_rid]


def prefill_ms_per_ktok(run) -> Optional[float]:
    recs = {id(r): r for r in admitted(run)}.values()
    tokens = sum(len(r.item.prompt) - 1 for r in recs)
    if not tokens:
        return None
    return sum(r.req.prefill_ms for r in recs) / (tokens / 1e3)


def prefill_flops(run, rec) -> float:
    """The prefill the configuration needs: the prompt but its last token,
    past what a registered prefix already holds."""
    return run.flops.prefill(rec.item.shared_tokens, len(rec.item.prompt) - 1)


def decode_flops(run) -> float:
    """Every token stamped in the window: one decode step at its position."""
    total = 0.0
    for r in run.window.reqs:
        s = len(r.item.prompt)
        n = sum(1 for t in r.token_s if t <= run.window.seconds)
        total += run.flops.decode(range(s - 1 + r.first_index, s - 1 + r.first_index + n))
    return total


def queue_wait_p95_ms(run) -> Optional[float]:
    """Over the requests whose wait for a first token did not overlap the
    traced stretch (the profiler slows the host)."""
    waits = []
    tr = run.tracer
    for r, t in ttft_pairs(run.window):
        if tr is not None and tr.win_t0 is not None and \
                r.item.due_s <= (tr.win_t1 or 1e30) and r.item.due_s + t / 1e3 >= tr.win_t0:
            continue
        waits.append(t - (r.req.prefill_ms if r.req is not None else 0.0))
    return quantile(waits, 0.95)


def roofline(run, kind: str) -> Optional[float]:
    """Sum of the least times of the traced stretch's launches of one
    kernel over the device time of that kernel's CUDA kernels in the
    stretch (by name: ``tracing.KERNEL_NAMES``), as a percentage."""
    tr, t = run.tracer, run.trace
    if tr is None or t is None:
        return None
    device_s = t.kernel_s.get(kind, 0.0)
    calls = tr.flash_calls if kind == "flash_attention" else tr.paged_calls
    if not calls or device_s <= 0:
        return None
    least = 0.0
    for c in calls:
        if kind == "flash_attention":
            b, h, sq, d = c["q"]
            _, kvh, sk, _ = c["k"]
            f, nb = costs.flash_attention_cost(b, h, sq, d, kvh, sk, c["elt"], c["causal"],
                                               c["window"], c["num_heads"], c["head_offset"])
        else:
            _, h, d = c["q"]
            _, ps, kvh, _ = c["pool"]
            f, nb = costs.paged_attention_cost(c["lengths"], h, d, kvh, ps, c["elt"],
                                               c["num_heads"], c["window"])
        least += costs.least_time_s(f, nb)
    return 100.0 * least / device_s


def idle_share(run) -> Optional[float]:
    t = run.trace
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def in_stretch(run, step) -> bool:
    tr = run.tracer
    return tr is not None and tr.win_t0 is not None and \
        step.t1 >= tr.win_t0 and step.t0 <= (tr.win_t1 if tr.win_t1 is not None else 1e30)
