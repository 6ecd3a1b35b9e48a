"""mfu.prefill.open (whole step, prefill): the model FLOPs the window's
prefills needed (a prompt past its registered prefix, no logits:
``cellbench/costs.py``) over their device time (``Request.prefill_ms``)
at the bf16 peak, as a percentage."""

from cellbench import costs
from cellbench.readers import admitted, prefill_flops


def read(run):
    if not run.cuda:
        return None
    recs = admitted(run)
    ms = sum(r.req.prefill_ms for r in {id(r): r for r in recs}.values())
    if not recs or ms <= 0:
        return None
    return 100.0 * sum(prefill_flops(run, r) for r in recs) / (ms / 1e3 * costs.PEAK_FLOPS_BF16)
