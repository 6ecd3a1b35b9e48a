"""flash_attention_roofline (kernels; ``.open``, ``.sat``): the least time the H100 could take for the
traced stretch's ``flash_attention`` launches (the larger of their operations over
989e12 FLOP/s and their bytes over 3.35e12 B/s, from each launch's own
shapes, window and lengths: ``cellbench/costs.py``) over the device time
of the kernels launched inside them, as a percentage."""

from cellbench.readers import roofline


def read(run):
    return roofline(run, "flash_attention")
