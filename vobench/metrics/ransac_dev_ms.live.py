"""ransac_dev_ms.live (ms/step), layer "essential matrix": the ``ransac``
stage inside the captured monocular step: the five-point samples, their
null spaces (H11), Nister's solver, MSAC's choice and the two refits, by
the graph's timing events (``openvo_tpu_torch/trace.py``), over the traced
steps. None where the step places no ``ransac`` mark. Moves step_ms."""

from vobench.harness import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "ransac")
