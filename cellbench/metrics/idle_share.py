"""idle_share (device; ``.open``, ``.sat``): the share of the traced stretch in which no
kernel, copy or fill ran on the card, as a percentage."""

from cellbench.readers import idle_share


def read(run):
    return idle_share(run)
