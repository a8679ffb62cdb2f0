"""orb_ms.live (ms/step), layer "features": CUDA-event time of ORB's entry
(``ops/orb.detect_and_compute``) alone on the cell's rectified left
frames and their depth masks, captured as the main path runs it, per step
(one instant's frames). Moves step_ms."""


def read(ctx):
    if ctx.layers is None:
        return None
    return ctx.layers["orb_ms"]
