"""Each metric's arithmetic on synthetic records, and the trace reduction
on synthetic profiler events."""

import types
from pathlib import Path

import numpy as np
import pytest

import cb_support  # noqa: F401
from cellbench import costs, drive, tracing
from cellbench.bench import Bench
from cellbench.traffic.generate import Item

METRICS = Path(__file__).resolve().parents[1] / "metrics"
CFG = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
       "intermediate_size": 128, "num_hidden_layers": 2, "vocab_size": 100}


def rec(rid, due, tokens, prompt=10, prefill_ms=5.0, shared=0, in_window=True, first=0):
    item = Item(rid=rid, prompt=np.zeros(prompt, np.int32), max_new_tokens=len(tokens),
                due_s=due, prefix=None, shared_tokens=shared)
    req = types.SimpleNamespace(prefill_ms=prefill_ms, finished_at=None, expired=False,
                                generated=[0] * len(tokens), max_new_tokens=len(tokens))
    return drive.ReqRec(item=item, req=req, submit_s=due if in_window else None,
                        token_s=list(tokens), delivered=len(tokens), in_window=in_window,
                        first_index=first)


def run_of(reqs, steps=(), seconds=10.0, stats=None):
    s0 = {"prefills": 0, "prefix_hits": 0}
    w = drive.Window(seconds=seconds, reqs=list(reqs), steps=list(steps), stats0=s0,
                     stats1=stats or s0)
    return types.SimpleNamespace(window=w, flops=costs.ModelFlops(CFG),
                                 tracer=None, trace=None, cuda=True)


def read(name, run):
    return Bench.reader(types.SimpleNamespace(here=METRICS.parent), name)(run)


def test_a_stalled_request_raises_ttft_p95():
    base = [rec(i, i * 0.1, [i * 0.1 + 0.2, i * 0.1 + 0.3]) for i in range(40)]
    calm = read("ttft_p95_ms", run_of(base))
    assert calm == pytest.approx(200.0)
    stalled = base + [rec(99 - i, 1.0 + i, []) for i in range(3)]   # no first token by 10 s
    assert read("ttft_p95_ms", run_of(stalled)) > 1000.0
    late = base + [rec(97, 1.0, [11.0])]                          # first token after the close
    assert drive.ttft_ms(run_of(late).window)[-1] == pytest.approx(9000.0)


def test_itl_and_out_tokens_count_only_the_window():
    r = rec(0, 0.0, [0.5, 0.6, 0.8, 10.5])
    warm = rec(1, 0.0, [1.0, 1.5], in_window=False, first=1)
    run = run_of([r, warm])
    assert sorted(drive.itl_ms(run.window)) == pytest.approx([100.0, 200.0, 500.0])
    assert read("out_tok_s", run) == pytest.approx(5 / 10.0)
    assert read("itl_p99_ms", run) == pytest.approx(np.quantile([100, 200, 500], 0.99))


def test_queue_wait_prefill_and_prefix_share():
    reqs = [rec(i, 0.0, [0.3], prompt=101, prefill_ms=100.0) for i in range(4)]
    steps = [drive.StepRec(0.0, 0.3, 4, 4, [0, 1, 2, 3])]
    run = run_of(reqs, steps, stats={"prefills": 4, "prefix_hits": 3})
    assert read("queue_wait_p95_ms.open", run) == pytest.approx(200.0)
    assert read("prefill_ms_per_ktok.open", run) == pytest.approx(1000.0)
    assert read("prefix_hit_share.open", run) == pytest.approx(75.0)
    flops = run.flops.prefill(0, 100) * 4
    assert read("mfu.prefill.open", run) == pytest.approx(
        100 * flops / (0.4 * costs.PEAK_FLOPS_BF16))


def test_decode_step_ms_skips_prefill_steps():
    steps = [drive.StepRec(0, 0.5, 1, 4, [0]), drive.StepRec(0.5, 0.6, 0, 4, []),
             drive.StepRec(0.6, 0.72, 0, 4, []), drive.StepRec(0.72, 0.86, 0, 4, [])]
    assert read("decode_step_ms", run_of([], steps)) == pytest.approx(120.0)


def test_rooflines_idle_and_moe_from_a_trace():
    tr = types.SimpleNamespace(
        flash_calls=[dict(q=(1, 4, 64, 16), k=(1, 4, 64, 16), elt=2, causal=True, window=None,
                          num_heads=4, head_offset=0)],
        paged_calls=[dict(q=(2, 4, 16), pool=(9, 4, 4, 16), elt=2, lengths=[5, 9],
                          num_heads=4, window=None)],
        prefill_tokens=63, decode_tokens=937)
    f1 = costs.least_time_s(*costs.flash_attention_cost(1, 4, 64, 16, 4, 64, 2, True, None, 4))
    f2 = costs.least_time_s(*costs.paged_attention_cost([5, 9], 4, 16, 4, 4, 2, 4))
    t = tracing.TraceResult(window_s=2.0, busy_s=0.5, device_ops=[], idle_gaps=[],
                            range_device_s={"cb.flash_attention": 4 * f1,
                                            "cb.paged_attention": 10 * f2, "cb.moe_ffn": 0.25},
                            matched_kernels=1, kernels=10,
                            kernel_s={"flash_attention": 4 * f1, "paged_attention": 10 * f2})
    run = run_of([])
    run.tracer, run.trace = tr, t
    assert read("flash_attention_roofline.open", run) == pytest.approx(25.0)
    assert read("paged_attention_roofline.sat", run) == pytest.approx(10.0)
    assert read("idle_share.open", run) == pytest.approx(75.0)
    assert read("moe_ffn_ms_per_ktok.sat", run) == pytest.approx(250.0)
    run.trace = None
    assert read("flash_attention_roofline.open", run) is None      # nothing to read: no number


class Ev:
    def __init__(self, name, act, start, dur, corr=0, user=False):
        self._v = (name, act, start, dur, corr, user)

    def name(self): return self._v[0]
    def activity_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def duration_ns(self): return self._v[3]
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return 0
    def is_user_annotation(self): return self._v[5]


def test_read_events_busy_gaps_and_ranges():
    evs = [Ev("cb.traced", "user_annotation", 0, 1000, user=True),
           Ev("cb.step", "user_annotation", 0, 900, user=True),
           Ev("cb.paged_attention", "user_annotation", 100, 50, user=True),
           Ev("cudaLaunchKernel", "cuda_runtime", 110, 5, corr=7),
           Ev("cudaLaunchKernel", "cuda_runtime", 400, 5, corr=8),
           Ev("paged_attention_split_kernel", "kernel", 200, 100, corr=7),
           Ev("flash_attention_sm90_kernel", "kernel", 950, 10, corr=10),
           Ev("gemm", "kernel", 250, 250, corr=8),
           Ev("gemm", "kernel", 800, 100, corr=9)]
    r = tracing.read_events(evs, 1e-6)
    assert r.busy_s == pytest.approx(410e-9)
    assert r.kernel_s == {"paged_attention": pytest.approx(100e-9),
                          "flash_attention": pytest.approx(10e-9)}
    assert r.range_device_s["cb.paged_attention"] == pytest.approx(100e-9)
    assert r.range_device_s["cb.step"] == pytest.approx(350e-9)
    assert dict(r.idle_gaps) == pytest.approx({"cb.step": 500e-9, "cb.harness": 90e-9})
    assert r.device_ops[0] == ("gemm", pytest.approx(350e-9))


class OldEv(Ev):
    """A profiler event without ``activity_type`` (older profilers): the
    device type tells kernels from host events."""

    def __getattribute__(self, name):
        if name == "activity_type":
            raise AttributeError(name)
        return object.__getattribute__(self, name)

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] == "kernel" else "DeviceType.CPU"

    def linked_correlation_id(self):
        return self._v[4] if self._v[1] == "kernel" else 0


def test_read_events_without_activity_type():
    evs = [OldEv("cb.traced", "user_annotation", 0, 1000, corr=1, user=True),
           OldEv("cb.moe_ffn", "user_annotation", 100, 300, corr=2, user=True),
           OldEv("aten::mm", "cpu_op", 150, 10, corr=3),
           OldEv("gemm", "kernel", 200, 100, corr=3),
           OldEv("gemm", "kernel", 600, 100, corr=9)]
    r = tracing.read_events(evs, 1e-6)
    assert r.kernels == 2 and r.busy_s == pytest.approx(200e-9)
    assert r.range_device_s == {"cb.moe_ffn": pytest.approx(100e-9)}


class _Engine:
    """An engine on a simulated clock: each step gives every live request
    one token; the step that starts past ``stall_at`` takes ``stall_s``."""

    def __init__(self, clock, step_s=0.05, stall_at=4.0, stall_s=3.0):
        self.clock, self.step_s, self.stall_at, self.stall_s = clock, step_s, stall_at, stall_s
        self.waiting, self.active, self.finished = [], {}, []
        self.stats = {"prefills": 0, "prefix_hits": 0}
        self.stalled = False

    def submit(self, req):
        self.waiting.append(req)

    def step(self):
        if not self.stalled and self.clock.t >= self.stall_at:
            self.stalled = True
            self.clock.t += self.stall_s
        self.clock.t += self.step_s
        for req in self.waiting:
            self.active[req.rid] = req
            self.stats["prefills"] += 1
        self.waiting = []
        for rid, req in list(self.active.items()):
            req.generated.append(0)
            if len(req.generated) >= req.max_new_tokens:
                req.finished_at = self.clock.t
                self.finished.append(self.active.pop(rid))
        return len(self.active)


def test_arrivals_during_a_stall_across_the_close_count_with_their_wait():
    from cellbench.traffic import generate
    from cellbench.traffic.kinds import poisson

    clock = cb_support.SimClock()
    items = [Item(rid=i, prompt=np.zeros(4, np.int32), max_new_tokens=2, due_s=0.5 * i,
                  prefix=None, shared_tokens=0) for i in range(12)]        # due 0 .. 5.5 s
    traffic = generate.Traffic(mix={"arrivals": {}}, kind=poisson, items=items, warm=[],
                               prefixes=[])
    Req = lambda rid, prompt, max_new_tokens: types.SimpleNamespace(   # noqa: E731
        rid=rid, prompt=prompt, max_new_tokens=max_new_tokens, generated=[],
        finished_at=None, expired=False, prefill_ms=0.0)
    w = drive.run_window(_Engine(clock), Req, traffic, 5.0, [], clock=clock, sleep=clock.sleep)
    missed = [r for r in w.reqs if r.req is None]
    # the stall runs from ~4.0 s past the close: the arrivals due at 4.5 s
    # (and at 4.0 s, if the loop had not reached it) were never submitted
    assert [r.item.due_s for r in missed] and all(4.0 <= r.item.due_s < 5.0 for r in missed)
    pairs = dict((r.item.rid, t) for r, t in drive.ttft_pairs(w))
    assert len(pairs) == 10                     # every arrival due before 5 s
    for r in missed:
        assert pairs[r.item.rid] == pytest.approx((5.0 - r.item.due_s) * 1e3)
    seen = [r for r in w.reqs if r.req is not None]
    assert read("ttft_p95_ms", run_of(w.reqs, seconds=5.0)) > \
        read("ttft_p95_ms", run_of(seen, seconds=5.0)) + 100.0
    assert read("queue_wait_p95_ms.open", run_of(w.reqs, seconds=5.0)) > \
        read("queue_wait_p95_ms.open", run_of(seen, seconds=5.0)) + 100.0


def test_the_check_samples_at_least_four_requests():
    from cellbench import check

    long = rec(0, 0.0, [1.0] * 300)
    short = [rec(i, 0.1 * i, [2.0] * 5) for i in range(1, 9)]
    for r in [long] + short:
        r.req.finished_at, r.req.max_new_tokens = 3.0, len(r.req.generated)
    picked = check.sample([long] + short, seed=7)
    assert picked[0] is long and len(picked) == check.MIN_REQUESTS
    assert len({id(r) for r in picked}) == len(picked)
