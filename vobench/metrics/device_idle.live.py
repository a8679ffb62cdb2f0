"""device_idle.live (%), layer "device", torch.profiler over the traced
span of the window: 100 x (1 - the union of the device's operations over
the span's length). Moves step_ms."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
