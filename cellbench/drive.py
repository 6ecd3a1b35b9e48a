"""Drive the port's ``ServeEngine`` through one measured window.

The engine is the program's entry: ``submit``, then ``step`` in a loop.
The harness stamps every output token on the host clock after the
``step()`` that produced it, from the scheduled arrival of its request,
and records each step's span and whether it admitted (prefilled) any
request.  A request evicted and restarted by the engine regenerates its
tokens; only tokens past those already delivered are stamped again.  An
open-loop request due before the window's close that the loop never got
to submit (a step ran across its arrival and the close) is kept without
an engine request: its time to first token is its wait to the close.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .traffic.generate import Item, Traffic, pages_per_seq

MARGIN_BYTES = 3 << 30          # left free beside the pool and the prefill peak


@dataclasses.dataclass
class ReqRec:
    item: Item
    req: object                 # the engine's Request (None: due, never submitted)
    submit_s: Optional[float] = None
    token_s: List[float] = dataclasses.field(default_factory=list)
    delivered: int = 0
    in_window: bool = True      # arrived in the window (False: warm lane)
    first_index: int = 0        # index of the first token stamped


@dataclasses.dataclass
class StepRec:
    t0: float
    t1: float
    prefills: int
    live: int
    admitted: List[int]


@dataclasses.dataclass
class Window:
    seconds: float
    reqs: List[ReqRec]
    steps: List[StepRec]
    stats0: Dict[str, int]
    stats1: Dict[str, int]
    trace: object = None


def engine_config(EngineConfig, mix: dict, num_pages: int):
    e = mix["engine"]
    return EngineConfig(max_batch=e["max_batch"], page_size=e["page_size"],
                        num_pages=num_pages, max_pages_per_seq=pages_per_seq(mix),
                        prefill_bucket=e["prefill_bucket"])


def page_bytes(cfg: dict, mix: dict, elt: int) -> int:
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    return (2 * cfg["num_hidden_layers"] * mix["engine"]["page_size"]
            * cfg["num_key_value_heads"] * hd * elt)


def make_request(Request, item: Item):
    return Request(rid=item.rid, prompt=item.prompt, max_new_tokens=item.max_new_tokens)


def size_pool(torch, ServeEngine, EngineConfig, Request, mcfg, params, cfg: dict, mix: dict,
              traffic: Traffic, device, elt: int) -> Dict[str, float]:
    """Warm up the engine on the traffic's longest prompt (prefill, the
    page install, decode steps at the cell's batch width) and size the
    pool: every byte left after the weights, that prefill's peak and a
    margin.  Returns the pool's pages and what set them."""
    longest = max(traffic.items + traffic.warm, key=lambda r: len(r.prompt))
    warm_pages = pages_per_seq(mix) + 2
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    if device.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(mcfg, params, engine_config(EngineConfig, mix, warm_pages), device=device)
    eng.submit(make_request(Request, dataclasses.replace(longest, rid=1 << 30, max_new_tokens=3)))
    eng.run_until_drained()
    sync()
    if device.type != "cuda":
        del eng
        return {"num_pages": mix["engine"].get("cpu_pages", 512)}
    # the prefill's own peak: the warm-up engine's small pool taken out
    pb = page_bytes(cfg, mix, elt)
    peak = torch.cuda.max_memory_allocated() - base - warm_pages * pb
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    num_pages = int((free - peak - MARGIN_BYTES) // pb)
    return {"num_pages": num_pages, "prefill_peak_bytes": peak, "free_bytes": free,
            "page_bytes": pb}


def _stats(engine) -> Dict[str, int]:
    return {k: v for k, v in engine.stats.items() if isinstance(v, int)}


def start_warm_lanes(engine, Request, traffic: Traffic) -> List[ReqRec]:
    """Set-up of a backlog: the warm lanes admitted (prefilled) and given
    their first token, so the window opens with every lane in service."""
    recs = []
    for item in traffic.warm:
        req = make_request(Request, item)
        engine.submit(req)
        recs.append(ReqRec(item=item, req=req, in_window=False))
    engine.step()
    for r in recs:
        r.delivered = r.first_index = len(r.req.generated)
    return recs


def run_window(engine, Request, traffic: Traffic, seconds: float, warm: List[ReqRec],
               tracer=None, clock=time.perf_counter, sleep=time.sleep) -> Window:
    """The measured window.  ``clock`` and ``sleep`` are the host's; the CPU
    tests give a simulated pair, so that a loaded test host does the same
    work."""
    open_loop = bool(traffic.kind.OPEN)
    depth = traffic.mix["arrivals"].get("depth", 0)
    items = traffic.items
    recs: List[ReqRec] = list(warm)
    inflight: List[ReqRec] = [r for r in warm if r.req.finished_at is None]
    steps: List[StepRec] = []
    nxt = 0
    stats0 = _stats(engine)
    t_start = clock()

    def submit(item: Item, now: float):
        req = make_request(Request, item)
        rec = ReqRec(item=item, req=req, submit_s=now)
        engine.submit(req)
        recs.append(rec)
        inflight.append(rec)

    while True:
        now = clock() - t_start
        if now >= seconds:
            break
        if open_loop:
            while nxt < len(items) and items[nxt].due_s <= now:
                submit(items[nxt], now)
                nxt += 1
        else:
            while len(engine.waiting) < depth:
                if nxt >= len(items):
                    raise RuntimeError("the backlog ran dry: raise max_rate_per_s")
                item = dataclasses.replace(items[nxt], due_s=now)
                submit(item, now)
                nxt += 1
        if not engine.waiting and not engine.active:
            wake = items[nxt].due_s if open_loop and nxt < len(items) else seconds
            sleep(max(0.0, min(wake, seconds) - now))
            continue
        if tracer is not None:
            tracer.before_step(now)
        before = set(engine.active)
        n_fin = len(engine.finished)
        p0 = engine.stats["prefills"]
        t0 = clock() - t_start
        live = engine.step()
        t1 = clock() - t_start
        done_now = {r.rid for r in engine.finished[n_fin:]}
        admitted = sorted((set(engine.active) | done_now) - before)
        steps.append(StepRec(t0, t1, engine.stats["prefills"] - p0, live, admitted))
        still = []
        for rec in inflight:
            n = len(rec.req.generated)
            while rec.delivered < n:
                rec.token_s.append(t1)
                rec.delivered += 1
            if rec.req.finished_at is None:
                still.append(rec)
        inflight[:] = still
        if tracer is not None:
            tracer.after_step(t1, live)
    if tracer is not None:
        tracer.finish(clock() - t_start)
    if open_loop:
        recs.extend(ReqRec(item=it, req=None) for it in items[nxt:] if it.due_s < seconds)
    return Window(seconds=seconds, reqs=recs, steps=steps, stats0=stats0,
                  stats1=_stats(engine), trace=tracer)


# ------------------------------------------------------------- statistics


def quantile(values, q: float) -> Optional[float]:
    """Linear interpolation between order statistics (numpy's default)."""
    if len(values) == 0:
        return None
    return float(np.quantile(np.asarray(values, dtype=np.float64), q))


def ttft_pairs(w: Window) -> List[Tuple[ReqRec, float]]:
    """Each request that arrived in the window with its time to first
    token in ms, from its scheduled arrival; one with no first token in
    the window (submitted or not) counts with the time it has waited."""
    out = []
    for r in w.reqs:
        if not r.in_window:
            continue
        first = r.token_s[0] if r.token_s and r.token_s[0] <= w.seconds else w.seconds
        out.append((r, (first - r.item.due_s) * 1e3))
    return out


def ttft_ms(w: Window) -> List[float]:
    return [t for _, t in ttft_pairs(w)]


def itl_ms(w: Window) -> List[float]:
    """Every gap between consecutive output tokens of one request, both
    stamped in the window."""
    out = []
    for r in w.reqs:
        ts = [t for t in r.token_s if t <= w.seconds]
        out.extend((b - a) * 1e3 for a, b in zip(ts, ts[1:]))
    return out


def out_tokens(w: Window) -> int:
    return sum(1 for r in w.reqs for t in r.token_s if t <= w.seconds)
