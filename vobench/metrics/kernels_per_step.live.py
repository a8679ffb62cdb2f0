"""kernels_per_step.live (kernels/step), layer "capture and API",
torch.profiler over the traced span of the window: the CUDA kernels started
in it over the steps it completed. Moves step_ms."""


def read(ctx):
    t = ctx.trace
    if t is None or t.units == 0:
        return None
    return t.kernels / t.units
