"""setup_s (s), end to end, host clock: from the start of the process to
the start of the window: imports, the kernels' load from the build cache
(their build on a checkout's first run), the render of the inputs, the
program's set-up and its first steps, which warm up and capture the step."""


def read(ctx):
    return ctx.setup_s
