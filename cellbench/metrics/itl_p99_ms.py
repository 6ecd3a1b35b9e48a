"""itl_p99_ms: 99th percentile of every gap between consecutive output
tokens of one request in the window, each token stamped after its step.
A window holds some 10^4 gaps, so the 99th percentile has hundreds
beyond it; it falls among steps that carry two prefills, where the 95th
fell on the edge between steps with one prefill and steps with two."""

from cellbench.drive import itl_ms, quantile


def read(run):
    return quantile(itl_ms(run.window), 0.99)
