"""depth_roofline.live (%), layer "depth kernels": the least time an H100
needs for SGBM's work on the frames of one call of the camera's depth entry
(``vobench/harness/roofline.py``), over that entry's CUDA-event time,
called alone on the cell's frames and captured as the main path runs it
(one call: one instant's pairs). Moves step_ms."""

from vobench.harness.roofline import least_seconds, sgbm_work


def read(ctx):
    if ctx.layers is None:
        return None
    cam, s = ctx.config["camera"], ctx.config["sgbm"]
    ops, nbytes = sgbm_work(cam["height"], cam["width"],
                            s["num_disparities"], s["block_size"],
                            s["num_paths"])
    n = ctx.layers["frames_per_call"]
    least, _ = least_seconds(ops * n, nbytes * n)
    return 100.0 * least / (ctx.layers["depth_ms"] * 1e-3)
