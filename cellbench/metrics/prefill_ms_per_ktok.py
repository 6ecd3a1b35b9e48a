"""prefill_ms_per_ktok (model step, prefill; ``.open``, ``.sat``): the window's prefills'
device milliseconds (``Request.prefill_ms``) per 1000 prompt tokens they
covered."""

from cellbench.readers import prefill_ms_per_ktok


def read(run):
    return prefill_ms_per_ktok(run)
