"""kernels_per_frame.replay (kernels/frame), layer "capture and API",
torch.profiler over the traced span of the window: the CUDA kernels started
in it over the frames it completed. Moves frames_per_s."""


def read(ctx):
    t, r = ctx.trace, ctx.records
    if t is None or t.units == 0 or r.window_steps == 0:
        return None
    return t.kernels / (t.units * r.window_frames / r.window_steps)
