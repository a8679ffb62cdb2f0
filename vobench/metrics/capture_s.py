"""capture_s (s), layer "capture and API": the seconds of the program's
graph warm-ups and captures (spans ``ovo.capture``,
``openvo_tpu_torch/trace.py``) that ended before the window: the part of
set-up that the first calls spend capturing. Moves setup_s."""

from vobench.harness import program_trace


def read(ctx):
    return program_trace.capture_s(ctx)
