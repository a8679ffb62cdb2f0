"""host_ms.live (ms/step), layer "capture and API": the time between one
traced step's graph end and the next one's start that lies under the
program's spans (``openvo_tpu_torch/trace.py``: results to the host,
unpacking, the next call's preparation, upload and launch), a step. The
rest of that time is the caller's. Moves step_ms."""

from vobench.harness import program_trace


def read(ctx):
    return program_trace.host_ms(ctx)
