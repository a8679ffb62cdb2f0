"""Entry ``stream``: an offline recorded sequence of one camera through
``parallel/stream.make_stream_fn``. A unit of the window is one call of
the stream on ``chunk`` frames, its poses, flags and skip codes read back
on the host after it."""

from __future__ import annotations

import time

from vobench.harness import check, drive, layers

build = drive.stereo_program
readings = check.readings


def run(prog, lefts, rights, traffic: dict, seconds: float, seed: int,
        trace_units: int = 0):
    """``lefts`` and ``rights`` are (frames, 1, H, W) uint8 in host memory.
    Returns (records, profiler or None, the stream)."""
    from openvo_tpu_torch.models.stereo_odometer import init_state
    from openvo_tpu_torch.parallel.stream import make_stream_fn

    if prog.cameras != 1:
        raise NotImplementedError("the stream entry runs one camera")
    frames = lefts.shape[0]
    chunk = traffic["chunk"]
    period = 2 * frames
    if period % chunk:
        raise ValueError(f"chunk {chunk} does not divide the period {period}")
    order = [drive.frame_index(i, frames) for i in range(period)]
    seq_l = drive.gather(lefts[:, 0], order)
    seq_r = drive.gather(rights[:, 0], order)
    stream = make_stream_fn(prog.camera, prog.config, chunk=chunk)
    cam = prog.camera
    state = init_state(cam.cropped_shape, prog.config.orb.max_keypoints,
                       cam.device)
    rec = drive.Records(matches=None, setup_steps=traffic["setup_steps"]
                        * chunk)
    span = drive.spans(trace_units > 0)

    def call(c):
        nonlocal state
        a = (c * chunk) % period
        with span("vobench.stream"):
            state, (ok, pose) = stream(state, seq_l[a:a + chunk],
                                       seq_r[a:a + chunk])
        with span("vobench.pose"):
            ok, pose = ok.cpu().numpy(), pose.cpu().numpy()
            codes = stream.skip_codes.cpu().numpy()
        for j in range(chunk):
            rec.frame.append(order[a + j])
            rec.success.append(ok[j:j + 1])
            rec.code.append(codes[j:j + 1])
            rec.pose.append(pose[j:j + 1])

    for c in range(traffic["setup_steps"]):
        t0 = time.perf_counter()
        call(c)
        rec.setup_step_s.append(time.perf_counter() - t0)
    sample = drive.Sample(traffic["samples"], seed, state.cur)
    _, prof = drive.window(rec, call, lambda c: sample.offer(c, state.cur),
                           traffic["setup_steps"], seconds, traffic,
                           trace_units, cam.device)
    rec.window_frames = rec.window_steps * chunk
    rec.feats = sample.features(lambda c: (c + 1) * chunk - 1)
    return rec, prof, stream


def time_layers(prog, traffic: dict, lefts, rights) -> dict:
    """The layers alone on a few of the cell's chunks, as the stream makes
    its calls."""
    frames, n = lefts.shape[0], traffic["chunk"]
    inputs = []
    for a in [0, 16, 32, 48]:
        idx = [drive.frame_index(a + j, frames) for j in range(n)]
        inputs.append(tuple(drive.gather(x[:, 0], idx)
                            for x in (lefts, rights)))
    return layers.time_layers(prog, inputs, n)
