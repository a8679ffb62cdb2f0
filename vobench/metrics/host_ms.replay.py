"""host_ms.replay (ms/frame), layer "capture and API": the time between one
traced chunk's graph end and the next one's start that lies under the
program's spans (``openvo_tpu_torch/trace.py``: upload, launch, the
outputs' clones), a frame. The rest of that time is the caller's. Moves
frames_per_s."""

from vobench.harness import program_trace


def read(ctx):
    return program_trace.host_ms(ctx, per_frame=True)
