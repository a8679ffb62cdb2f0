"""state_dev_ms.live (ms/step), layer "state": the ``state`` stage inside the
captured step: the state machine's selects, the packed results and the
static-buffer copies, by the graph's timing events
(``openvo_tpu_torch/trace.py``), over the traced steps. Moves step_ms."""

from vobench.harness import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "state")
