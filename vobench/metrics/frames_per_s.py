"""frames_per_s (frames/s), end to end, host clock: every frame whose pose
was on the host within the window, over the window's seconds (a rig's
instant is as many frames as it has cameras)."""


def read(ctx):
    r = ctx.records
    if r.window_frames == 0 or r.window_s <= 0:
        return None
    return r.window_frames / r.window_s
