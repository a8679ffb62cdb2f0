"""Entry ``mono``: one camera's frames through the monocular odometer's
public step, ``MonoOdometer.update(img, trans_scale)``, one frame a call,
as a vehicle or drone with one camera runs it (on the card one captured
graph a call, its samples drawn by the odometer's own generator). A unit
of the window is one frame: the left image goes to ``update``, then the
pose is read on the host. ``trans_scale`` is the mix's, the scale a
vehicle takes from its wheel odometry.

The frames are shown forward then back, each end frame once (0 .. n-1,
then n-2 .. 1): a frame shown twice in a row has no parallax, its E is
undefined, and a monocular pipeline keeps a stationary camera out.
"""

import dataclasses
import time

import numpy as np
import torch

from vobench.harness import drive, mono_check
from vobench.harness.render import intrinsics

readings = mono_check.readings


def frame_index(i: int, frames: int) -> int:
    """The frame shown at step ``i``: forward through the sequence, then
    backward, no frame twice in a row (period 2 * frames - 2)."""
    j = i % (2 * frames - 2)
    return j if j < frames else 2 * frames - 2 - j


@dataclasses.dataclass
class Program:
    """The monocular system under test as one configuration builds it."""

    K: np.ndarray        # 3x3 intrinsics
    config: object       # openvo_tpu_torch.OdometerConfig
    mono: dict           # MonoOdometer's RANSAC settings
    device: torch.device


def build(config: dict, device) -> Program:
    """The configuration's intrinsics (``camera``), ``OdometerConfig``
    (``orb``, ``odometer``) and RANSAC settings (``mono``)."""
    from openvo_tpu_torch import OdometerConfig, ORBParams

    orb = ORBParams(**config["orb"])
    cfg = OdometerConfig(nfeatures=orb.nfeatures, orb=orb,
                         **config["odometer"])
    return Program(intrinsics(config["camera"]), cfg, dict(config["mono"]),
                   torch.device(device))


@dataclasses.dataclass
class Records(drive.Records):
    """``drive.Records`` with what the monocular check reads besides: a
    row's inliers and the odometer's skip count after it."""

    inliers: list = dataclasses.field(default_factory=list)
    skipped: list = dataclasses.field(default_factory=list)


class Sample(drive.Sample):
    """``drive.Sample`` of the odometer's kept frame (keypoints,
    descriptors, valid flags): the same draw and copies, over the mono
    frame's fields in place of ``drive.fields`` (which reads a disparity
    the mono frame lacks)."""

    def __init__(self, k: int, seed: int, cur):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.seen = 0
        self.units = []
        self.buffers = [tuple(torch.empty_like(x) for x in cur)
                        for _ in range(k)]

    def offer(self, unit, cur) -> None:
        n = self.seen
        self.seen += 1
        if n < self.k:
            self.units.append(unit)
            slot = n
        else:
            slot = int(self.rng.integers(0, n + 1))
            if slot >= self.k:
                return
            self.units[slot] = unit
        for dst, src in zip(self.buffers[slot], cur):
            dst.copy_(src, non_blocking=True)


def run(prog, lefts, rights, traffic: dict, seconds: float, seed: int,
        trace_units: int = 0):
    """Set-up steps, then the window. ``lefts`` is (frames, 1, H, W) uint8
    in host memory (``rights`` are not read). Returns (records, profiler
    or None, the odometer)."""
    from openvo_tpu_torch.models.mono_odometer import MonoOdometer

    frames = lefts.shape[0]
    scale = float(traffic["trans_scale"])
    rec = Records(setup_steps=traffic["setup_steps"])
    span = drive.spans(trace_units > 0)
    odo = MonoOdometer(prog.K, config=prog.config, device=prog.device,
                       **prog.mono)
    raw = []   # (frame, ok, stats, skipped, pose) a step, as given

    def step(i):
        t = frame_index(i, frames)
        with span("vobench.update"):
            ok = odo.update(lefts[t, 0], scale)
            with span("vobench.pose"):
                pose = odo.state.c_T_w.cpu().numpy()
            raw.append((t, ok, odo.last_stats, odo.skipped_frames, pose))

    for i in range(rec.setup_steps):
        t0 = time.perf_counter()
        step(i)
        rec.setup_step_s.append(time.perf_counter() - t0)
    sample = Sample(traffic["samples"], seed, odo.state.cur)
    _, prof = drive.window(rec, step, lambda i: sample.offer(i, odo.state.cur),
                           rec.setup_steps, seconds, traffic, trace_units,
                           prog.device)
    for t, ok, stats, skipped, pose in raw:
        rec.frame.append(t)
        rec.success.append(np.asarray([ok], bool))
        rec.code.append(np.asarray(stats["skip_code"]).reshape(-1))
        rec.matches.append(np.asarray(stats["n_matches"]).reshape(-1))
        rec.inliers.append(int(stats["n_inliers"]))
        rec.skipped.append(skipped)
        rec.pose.append(np.asarray(pose, np.float32).reshape(-1, 4, 4))
    rec.window_frames = rec.window_steps
    rec.feats = sample.features()
    return rec, prof, odo


def time_layers(prog, traffic: dict, lefts, rights):
    """None: no metric of a monocular cell times a layer alone; its stages
    are read inside the captured step (``program_trace.device_ms``)."""
    return None
