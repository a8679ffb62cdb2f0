"""orb_dev_ms.live (ms/step), layer "features": the ``orb`` stage inside the
captured step: the depth mask and ORB (the rest of ``extract``), by the
graph's timing events (``openvo_tpu_torch/trace.py``), over the traced
steps. Moves step_ms."""

from vobench.harness import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "orb")
