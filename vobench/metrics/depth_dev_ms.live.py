"""depth_dev_ms.live (ms/step), layer "depth kernels": the ``depth`` stage
inside the captured step: rectify, SGBM, reprojection (``extract``'s
``compute3d``), by the graph's timing events
(``openvo_tpu_torch/trace.py``), over the traced steps. Moves step_ms."""

from vobench.harness import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "depth")
