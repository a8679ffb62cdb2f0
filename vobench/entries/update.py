"""Entry ``update``: the odometer's public step, one instant a call, as a
vehicle runs it. One camera goes through ``StereoOdometer.update``, a rig
of several through ``parallel/rig.RigOdometer.update`` (one batched step
an instant). A unit of the window is one instant: its pairs go to
``update``, then the poses are read on the host."""

from __future__ import annotations

import time

import numpy as np

from vobench.harness import check, drive, layers

build = drive.stereo_program
readings = check.readings


def run(prog, lefts, rights, traffic: dict, seconds: float, seed: int,
        trace_units: int = 0):
    """Set-up steps, then the window. ``lefts`` and ``rights`` are
    (frames, cameras, H, W) uint8 in host memory. Returns (records,
    profiler or None, the odometer)."""
    from openvo_tpu_torch import StereoOdometer
    from openvo_tpu_torch.parallel.rig import RigOdometer

    frames = lefts.shape[0]
    rec = drive.Records(setup_steps=traffic["setup_steps"])
    span = drive.spans(trace_units > 0)
    raw = []   # (frame, ok, stats, pose) a step, as the program gave them
    if prog.cameras == 1:
        odo = StereoOdometer(prog.camera, config=prog.config)

        def call(t):
            ok = odo.update(lefts[t, 0], rights[t, 0])
            with span("vobench.pose"):
                pose = odo.c_T_w
            return ok, odo.last_stats, pose
    else:
        odo = RigOdometer(prog.camera, prog.cameras, prog.config)

        def call(t):
            ok = odo.update(lefts[t], rights[t])
            with span("vobench.pose"):
                pose = odo.state.c_T_w.cpu().numpy()
            return ok, odo.last_stats, pose

    def step(i):
        t = drive.frame_index(i, frames)
        with span("vobench.update"):
            raw.append((t, *call(t)))

    for i in range(rec.setup_steps):
        t0 = time.perf_counter()
        step(i)
        rec.setup_step_s.append(time.perf_counter() - t0)
    sample = drive.Sample(traffic["samples"], seed, odo.state.cur)
    _, prof = drive.window(rec, step,
                           lambda i: sample.offer(i, odo.state.cur),
                           rec.setup_steps, seconds, traffic, trace_units,
                           prog.camera.device)
    for t, ok, stats, pose in raw:
        rec.frame.append(t)
        rec.success.append(np.asarray(ok, bool).reshape(-1))
        rec.code.append(np.asarray(stats["skip_code"]).reshape(-1))
        rec.matches.append(np.asarray(stats["n_matches"]).reshape(-1))
        rec.pose.append(np.asarray(pose, np.float32).reshape(-1, 4, 4))
    rec.window_frames = rec.window_steps * prog.cameras
    rec.feats = sample.features()
    return rec, prof, odo


def time_layers(prog, traffic: dict, lefts, rights) -> dict:
    """The layers alone on a few of the cell's instants (one pair, or a
    rig's pairs), as ``update`` makes its calls."""
    starts = [0, 16, 32, 48]
    if prog.cameras == 1:
        inputs = [(lefts[t, 0], rights[t, 0]) for t in starts]
    else:
        inputs = [(lefts[t], rights[t]) for t in starts]
    return layers.time_layers(prog, inputs, prog.cameras)
