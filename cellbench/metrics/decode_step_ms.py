"""decode_step_ms (model step, decode): median host-clock duration of the
window's ``step()`` calls that admitted no request, outside the traced
stretch (the profiler slows the host)."""

from cellbench.drive import quantile
from cellbench.readers import in_stretch


def read(run):
    ms = [(s.t1 - s.t0) * 1e3 for s in run.window.steps
          if s.prefills == 0 and s.live and not in_stretch(run, s)]
    return quantile(ms, 0.5)
