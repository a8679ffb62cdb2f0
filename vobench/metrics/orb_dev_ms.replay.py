"""orb_dev_ms.replay (ms/frame), layer "features": the ``orb`` stage inside
the captured step: the depth mask and ORB (the rest of ``extract``), by the
graph's timing events (``openvo_tpu_torch/trace.py``), over the traced
chunks' frames. Moves frames_per_s."""

from vobench.harness import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "orb", per_frame=True)
