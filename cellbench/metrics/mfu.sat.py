"""mfu.sat (whole step): the model FLOPs of all the window's work (its
prefills and every token it decoded, an MoE layer counting its routed
experts only) over the window's seconds at the bf16 peak, as a
percentage."""

from cellbench import costs
from cellbench.readers import admitted, decode_flops, prefill_flops


def read(run):
    if not run.cuda:
        return None
    flops = decode_flops(run) + sum(prefill_flops(run, r) for r in admitted(run))
    if flops <= 0:
        return None
    return 100.0 * flops / (run.window.seconds * costs.PEAK_FLOPS_BF16)
