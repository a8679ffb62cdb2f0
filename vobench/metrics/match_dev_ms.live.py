"""match_dev_ms.live (ms/step), layer "matching": the ``match`` stage inside
the captured step: both attempts' ratio-test matching and 3D sampling, by
the graph's timing events (``openvo_tpu_torch/trace.py``), over the traced
steps. Moves step_ms."""

from vobench.harness import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "match")
