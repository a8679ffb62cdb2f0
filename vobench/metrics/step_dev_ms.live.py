"""step_dev_ms.live (ms/step), layer "device": the whole captured step on the
device, from its graph's ``start`` mark to its last, by the graph's timing
events (``openvo_tpu_torch/trace.py``), over the traced steps. Moves
step_ms."""

from vobench.harness import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "step")
