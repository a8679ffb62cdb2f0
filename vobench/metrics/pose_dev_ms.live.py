"""pose_dev_ms.live (ms/step), layer "pose fit and gates": the ``pose`` stage
inside the captured step: both attempts' filters, Kabsch fit and motion
gates, by the graph's timing events (``openvo_tpu_torch/trace.py``), over
the traced steps. Moves step_ms."""

from vobench.harness import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "pose")
