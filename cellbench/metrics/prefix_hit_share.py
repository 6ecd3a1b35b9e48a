"""prefix_hit_share (engine; ``.open``): the engine's ``prefix_hits`` over its
``prefills`` in the window, as a percentage (0 where no prefix is
registered: the unshared control)."""


def read(run):
    s0, s1 = run.window.stats0, run.window.stats1
    prefills = s1["prefills"] - s0["prefills"]
    if not prefills:
        return None
    return 100.0 * (s1["prefix_hits"] - s0["prefix_hits"]) / prefills
