"""step_ms (ms), end to end, host clock: the window's seconds over the
units it completed (in a live mix a unit is a step: one instant's pairs
handed to ``update`` until the poses are on the host)."""


def read(ctx):
    r = ctx.records
    if r.window_steps == 0:
        return None
    return 1e3 * r.window_s / r.window_steps
