"""queue_wait_p95_ms (engine; ``.open``): 95th percentile over the window's
requests of the time to first token less the request's own prefill
(``Request.prefill_ms``, the engine's CUDA events around prefill and
page install): waiting for a lane, for the step in progress and for the
prefills admitted ahead of it.  Requests whose wait overlapped the
profiled stretch are left out (the profiler slows the host)."""

from cellbench.readers import queue_wait_p95_ms


def read(run):
    return queue_wait_p95_ms(run)
