"""orb_ms.replay (ms/frame), layer "features": CUDA-event time of ORB's
entry (``ops/orb.detect_and_compute``) alone on the cell's rectified left
frames and their depth masks, captured as the main path runs it, per frame
(a chunk's time over its frames). Moves frames_per_s."""


def read(ctx):
    if ctx.layers is None:
        return None
    return ctx.layers["orb_ms"] / ctx.layers["frames_per_call"]
