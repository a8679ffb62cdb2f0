"""fallback_share.live (%), layer "matching": the share of the traced
camera-steps whose result came from the fallback attempt against the frame
before last (counter ``ovo.fallback``, ``openvo_tpu_torch/trace.py``). The
step computes both attempts every time, so this is the share of the
fallback's match and fit work that was used. Moves step_ms."""

from vobench.harness import program_trace


def read(ctx):
    return program_trace.fallback_share(ctx)
