"""The traced run: ``torch.profiler`` over a fixed stretch of the window,
and ``record_function`` ranges the harness puts around the program's
calls from outside (the program has no spans of its own inside a step).

Ranges (host side): ``cb.step`` (``ServeEngine.step``), ``cb.admit``
(``_try_admit``), ``cb.prefill`` (``_prefill_into_pool``),
``cb.sync_tables`` (``_sync_tables``), ``cb.decode_step``
(``transformer.decode_step``), ``cb.settle`` (``_settle_prefill_times``,
right after the step's argmax read), ``cb.flash_attention``,
``cb.paged_attention`` and ``cb.moe_ffn`` (the ``models.blocks`` names
of the kernels and of ``moe_forward``), with each launch's shapes and
lengths recorded for the roofline.

From the profiler's events: the device's busy time (the union of every
kernel, copy and fill), the idle gaps between them, each labelled with
the innermost range the host was in when the gap began, the device time
of the kernels launched inside each range (matched to their launch by
correlation id), and the device operations that took most time.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# the kernels whose rooflines are read, by their CUDA names
# (``csrc/flash_attention.cu``, ``csrc/paged_attention.cu``); the profiler
# gives the demangled signature, which contains the name
KERNEL_NAMES = {"flash_attention": ("flash_bf16_kernel", "flash_f32_kernel",
                                       "flash_attention_sm90_kernel"),
                   "paged_attention": ("paged_attention_split_kernel",
                                       "paged_attention_merge_kernel")}


@dataclasses.dataclass
class TraceResult:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    range_device_s: Dict[str, float]
    kernel_s: Dict[str, float]          # device seconds of KERNEL_NAMES' kernels
    matched_kernels: int
    kernels: int


def _patch(obj, name, wrap, undo):
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    undo.append((obj, name, orig))


class Tracer:
    """Profiles the window from the first step that begins at or after
    ``start_s`` to its close; the profiler stops, and its events are read,
    once the window has closed."""

    def __init__(self, torch, engine, start_s: float):
        self.torch = torch
        self.engine = engine
        self.cuda = engine.device.type == "cuda"
        self.start_s = start_s
        self.prof = None
        self.result: Optional[TraceResult] = None
        self.flash_calls: List[dict] = []
        self.paged_calls: List[dict] = []
        self.moe_rows = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.traced_steps: List[int] = []
        self._undo: List[tuple] = []
        self._outer = None
        self._t0 = self._t1 = 0.0
        self.win_t0: Optional[float] = None      # the stretch, in window seconds
        self.win_t1: Optional[float] = None

    # -------------------------------------------------------- instrumenting

    def _ranged(self, name, record=None):
        rf = self.torch.profiler.record_function

        def wrap(fn):
            def inner(*args, **kw):
                if record is not None:
                    record(*args, **kw)
                with rf(name):
                    return fn(*args, **kw)
            return inner
        return wrap

    def _install(self):
        import repro_torch.models.blocks as blocks
        import repro_torch.models.transformer as transformer

        def flash(q, k, v, causal=True, window=None, num_heads=None, head_offset=0, **_):
            self.flash_calls.append(dict(q=tuple(q.shape), k=tuple(k.shape),
                                         elt=q.element_size(), causal=causal, window=window,
                                         num_heads=num_heads, head_offset=head_offset))

        def paged(q, k_pool, v_pool, table, lengths, num_heads=None, window=None, **_):
            self.paged_calls.append(dict(q=tuple(q.shape), pool=tuple(k_pool.shape),
                                         elt=q.element_size(), lengths=lengths,
                                         num_heads=num_heads, window=window))

        def moe(p, x, *a, **kw):
            self.moe_rows += x.shape[0] * x.shape[1]

        def prefill(req):
            self.prefill_tokens += len(req.prompt) - 1

        eng, undo = self.engine, self._undo
        _patch(blocks, "flash_attention", self._ranged("cb.flash_attention", flash), undo)
        _patch(blocks, "paged_attention", self._ranged("cb.paged_attention", paged), undo)
        _patch(blocks, "moe_forward", self._ranged("cb.moe_ffn", moe), undo)
        _patch(transformer, "decode_step", self._ranged("cb.decode_step"), undo)
        for attr, name, rec in (("step", "cb.step", None), ("_try_admit", "cb.admit", None),
                                ("_prefill_into_pool", "cb.prefill", prefill),
                                ("_sync_tables", "cb.sync_tables", None),
                                ("_settle_prefill_times", "cb.settle", None)):
            _patch(eng, attr, self._ranged(name, rec), undo)

    def _uninstall(self):
        for obj, name, orig in reversed(self._undo):
            if isinstance(obj, type(self.engine)) and name in vars(obj):
                delattr(obj, name)          # the instance's own patch; the method shows again
            else:
                setattr(obj, name, orig)
        self._undo.clear()

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: its first start in a
        process (CUPTI's) takes seconds, which would stall the window."""
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts):
            torch.ones(8, device=self.engine.device).sum()
            self._sync()

    # -------------------------------------------------------------- window

    def before_step(self, now: float) -> None:
        if self.prof is None and self.result is None and now >= self.start_s:
            import time
            torch = self.torch
            self._install()
            self._sync()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self._outer = torch.profiler.record_function("cb.traced")
            self._outer.__enter__()
            self._t0 = time.perf_counter()
            self.win_t0 = now

    def after_step(self, now: float, live: int) -> None:
        if self.prof is not None:
            self.decode_tokens += live

    def finish(self, now: float) -> None:
        if self.prof is not None:
            self.win_t1 = now
            self._stop()

    def _sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def _stop(self) -> None:
        import time
        self._sync()
        self._t1 = time.perf_counter()
        self._outer.__exit__(None, None, None)
        self.prof.stop()
        self._uninstall()
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        self.result = read_events(events, self._t1 - self._t0)

    def paged_lengths(self) -> None:
        """The lengths each decode launch read (device tensors until now)."""
        for c in self.paged_calls:
            if not isinstance(c["lengths"], list):
                c["lengths"] = [int(x) for x in c["lengths"].tolist()]


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _kind(ev) -> str:
    """``device`` (a kernel, copy or fill on the card), ``range`` (a
    ``cb.*`` annotation on the host) or ``host`` (any other host event).
    Newer profilers say so in ``activity_type``; older ones by the device."""
    name = ev.name()
    act = getattr(ev, "activity_type", None)
    if act is not None:
        act = str(act())
        if act in ("kernel", "gpu_memcpy", "gpu_memset"):
            return "device"
        return "range" if act == "user_annotation" and name.startswith("cb.") else "host"
    if str(ev.device_type()).endswith("CUDA"):
        return "host" if name.startswith("cb.") else "device"
    return "range" if name.startswith("cb.") else "host"


def read_events(events, window_s: float) -> TraceResult:
    """Reduce the profiler's events (``kineto_results.events()``) to the
    traced stretch's busy time, idle gaps, device time by range and by
    kernel, and the costliest device operations.  A device event is tied
    to the host event that launched it by its linked correlation id (the
    innermost op or annotation open at the launch, as the profiler's own
    tables tie them), else by its correlation id (the runtime call)."""
    device, launches, ranges = [], {}, []
    traced = None
    for ev in events:
        kind = _kind(ev)
        start = ev.start_ns()
        if kind == "device":
            corr = getattr(ev, "correlation_id", lambda: 0)()
            device.append((start, start + ev.duration_ns(), ev.name(), corr,
                           ev.linked_correlation_id()))
            continue
        corr = getattr(ev, "correlation_id", lambda: 0)()
        if corr:
            launches.setdefault(corr, start)
        if kind == "range":
            name = ev.name()
            if name == "cb.traced":
                traced = (start, start + ev.duration_ns())
            else:
                ranges.append((start, start + ev.duration_ns(), name))
    if traced is None:
        lo = min((d[0] for d in device), default=0)
        traced = (lo, lo + int(window_s * 1e9))
    t0, t1 = traced
    busy = _merge([(max(s, t0), min(e, t1)) for s, e, *_ in device if e > t0 and s < t1])
    busy_ns = sum(e - s for s, e in busy)

    by_op: Dict[str, float] = defaultdict(float)
    for s, e, name, *_ in device:
        by_op[name] += (e - s) / 1e9
    device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]

    # innermost range the host was in when each idle gap began (the
    # ranges nest: a stack swept along the gaps in time order)
    ranges.sort()
    gaps: Dict[str, float] = defaultdict(float)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    stack: List[Tuple[int, int, str]] = []
    nxt = 0
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        while nxt < len(ranges) and ranges[nxt][0] <= g0:
            while stack and stack[-1][1] <= ranges[nxt][0]:
                stack.pop()
            stack.append(ranges[nxt])
            nxt += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        gaps[stack[-1][2] if stack else "cb.harness"] += (g1 - g0) / 1e9
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]

    # device time of the kernels launched inside each kind of range
    spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    for s, e, name in ranges:
        spans[name].append((s, e))
    merged = {k: _merge(v) for k, v in spans.items()}
    heads = {k: [iv[0] for iv in v] for k, v in merged.items()}
    in_range: Dict[str, float] = defaultdict(float)
    matched = 0
    for s, e, name, corr, linked in device:
        t = launches.get(linked) if linked else launches.get(corr)
        if t is None:
            continue
        matched += 1
        for k, ivs in merged.items():
            i = bisect.bisect_right(heads[k], t) - 1
            if i >= 0 and ivs[i][1] >= t:
                in_range[k] += (e - s) / 1e9
    kernel_s = {k: sum((e - s) for s, e, name, *_ in device if any(n in name for n in names)) / 1e9
                for k, names in KERNEL_NAMES.items()}
    return TraceResult(window_s=window_s, busy_s=busy_ns / 1e9, device_ops=device_ops,
                       idle_gaps=idle_gaps, range_device_s=dict(in_range),
                       kernel_s=kernel_s, matched_kernels=matched, kernels=len(device))
