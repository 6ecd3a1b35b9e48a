"""out_tok_s: every output token stamped in the window over its seconds."""

from cellbench.drive import out_tokens


def read(run):
    n = out_tokens(run.window)
    return n / run.window.seconds if n else None
