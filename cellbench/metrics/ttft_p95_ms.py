"""ttft_p95_ms: 95th percentile of the time to first token of every request
that arrived in the window, from its scheduled arrival to the host clock
after the step that produced the token; a request with none by the
window's end counts with the time it waited."""

from cellbench.drive import quantile, ttft_ms


def read(run):
    return quantile(ttft_ms(run.window), 0.95)
