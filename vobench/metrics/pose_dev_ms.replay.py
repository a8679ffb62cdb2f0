"""pose_dev_ms.replay (ms/frame), layer "pose fit and gates": the ``pose``
stage inside the captured step: both attempts' filters, Kabsch fit and
motion gates, by the graph's timing events (``openvo_tpu_torch/trace.py``),
over the traced chunks' frames. Moves frames_per_s."""

from vobench.harness import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "pose", per_frame=True)
