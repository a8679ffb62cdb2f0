"""step_dev_ms.replay (ms/frame), layer "device": the whole captured step on
the device, from its graph's ``start`` mark to its last, by the graph's
timing events (``openvo_tpu_torch/trace.py``), over the traced chunks'
frames. Moves frames_per_s."""

from vobench.harness import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "step", per_frame=True)
