"""What every entry shares: the stereo program as a configuration builds
it, the records of a run, the sample of kept features, the arrival process
of a traffic mix, and the measured window.

An entry (``vobench/entries/<entry>.py``, named by a traffic mix's
``entry``) drives one API of the program through :func:`window`. In a
traced run, spans of the harness (``torch.profiler.record_function``) name
the calls into each layer: ``vobench.update`` and ``vobench.stream`` the
entry, ``vobench.pose`` the read of the result on the host,
``vobench.step`` one unit of the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time

import numpy as np
import torch

from vobench.harness.render import intrinsics


def frame_index(i: int, frames: int) -> int:
    """The frame shown at step ``i``: forward through the sequence, then
    backward, each end frame shown twice (period 2 * frames)."""
    j = i % (2 * frames)
    return j if j < frames else 2 * frames - 1 - j


def gather(frames, order):
    """frames[order] in host memory of the same kind (pinned stays
    pinned)."""
    out = torch.empty((len(order),) + tuple(frames.shape[1:]),
                      dtype=frames.dtype, pin_memory=frames.is_pinned())
    torch.index_select(frames, 0, torch.as_tensor(order), out=out)
    return out


@dataclasses.dataclass
class Program:
    """The stereo system under test as one configuration builds it."""

    camera: object        # openvo_tpu_torch.StereoCamera
    config: object        # openvo_tpu_torch.OdometerConfig
    cameras: int


def stereo_program(config: dict, device) -> Program:
    """The configuration's ``StereoCamera`` (its ``camera`` and ``sgbm``
    groups) and ``OdometerConfig`` (``orb`` and ``odometer``)."""
    from openvo_tpu_torch import (OdometerConfig, ORBParams, SGBMParams,
                                  StereoCamera)

    c = config["camera"]
    K = intrinsics(c)
    dist = np.zeros(5)
    rect = {"R": np.eye(3), "T": np.array([-c["baseline_m"], 0.0, 0.0])}
    cam = StereoCamera(K, dist, K, dist, rect, SGBMParams(**config["sgbm"]),
                       (c["width"], c["height"]), device=device)
    odo = dict(config["odometer"])
    odo["max_rotation_change"] = math.pi / odo.pop(
        "max_rotation_change_pi_over")
    orb = ORBParams(**config["orb"])
    cfg = OdometerConfig(nfeatures=orb.nfeatures, orb=orb, **odo)
    return Program(cam, cfg, config["cameras"])


@dataclasses.dataclass
class Records:
    """What the program handed back, one row a frame step (a rig's
    cameras along each row's first axis), and the window's timing."""

    frame: list = dataclasses.field(default_factory=list)
    success: list = dataclasses.field(default_factory=list)   # (cams,)
    code: list = dataclasses.field(default_factory=list)      # (cams,)
    matches: list | None = dataclasses.field(default_factory=list)
    pose: list = dataclasses.field(default_factory=list)      # (cams, 4, 4)
    latency_s: list = dataclasses.field(default_factory=list)  # a unit each
    feats: dict = dataclasses.field(default_factory=dict)  # row -> copies
    setup_steps: int = 0       # rows before the window
    setup_step_s: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    window_steps: int = 0      # units of the window
    window_frames: int = 0     # frames the window's units completed
    window_start: float = 0.0


def fields(cur) -> tuple:
    """The fields of the state's last accepted frame that are compared:
    disparity, keypoints, descriptors, valid flags (a rig's cameras on the
    first axis)."""
    return cur.disp, cur.kp_xy, cur.desc, cur.kp_valid


class Sample:
    """A uniform sample of ``k`` window units drawn from the seed as the
    window runs (its length is not known ahead), with a copy of the
    program's kept features after each unit taken. The copies go into
    buffers allocated at set-up, so the window allocates nothing."""

    def __init__(self, k: int, seed: int, cur):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.seen = 0
        self.units = []
        self.buffers = [tuple(torch.empty_like(x) for x in fields(cur))
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
        for dst, src in zip(self.buffers[slot], fields(cur)):
            dst.copy_(src, non_blocking=True)

    def features(self, row_of=lambda unit: unit) -> dict:
        """{the row after which the features were kept: the copies}."""
        return {row_of(u): b for u, b in zip(self.units, self.buffers)}


class Arrivals:
    """The arrival process of a traffic mix's ``arrivals``: ``"closed"``
    (one client: a unit arrives when the last one's result is on the host)
    or ``{"rate_hz": r}`` (a unit every 1/r s from the window's start, as a
    camera's clock delivers frames; a late unit waits in the queue, and its
    latency counts the wait)."""

    def __init__(self, arrivals="closed"):
        if arrivals == "closed":
            self.period = None
        elif isinstance(arrivals, dict) and arrivals.get("rate_hz", 0) > 0:
            self.period = 1.0 / float(arrivals["rate_hz"])
        else:
            raise ValueError(f"unknown arrivals {arrivals!r}")

    def arrive(self, k: int, t0: float) -> float:
        """The host-clock time unit ``k`` of the window arrives, once it
        has (sleeping until then where it is not due yet)."""
        now = time.perf_counter()
        if self.period is None:
            return now
        due = t0 + k * self.period
        while now < due:
            time.sleep(min(due - now, 0.002))
            now = time.perf_counter()
        return due


class _Profiled:
    """torch.profiler over the window's units [first, first + count) of a
    traced run (none where count is 0)."""

    def __init__(self, first: int, count: int, device):
        self.first, self.last = first, first + count
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None

    def enter(self, unit: int):
        if unit == self.first and self.last > self.first:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
                torch.cuda.synchronize()
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()

    def leave(self, unit: int):
        if unit == self.last - 1 and self.prof is not None:
            if self.cuda:
                torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)


def spans(on: bool):
    """The harness's span (``torch.profiler.record_function``) in a traced
    run; elsewhere a context that costs nothing."""
    return torch.profiler.record_function if on else (
        lambda name: contextlib.nullcontext())


def window(rec: Records, unit, after, first: int, seconds: float,
           traffic: dict, trace_units: int, device):
    """The measured window: ``unit(i)`` for i = first, first + 1, ... as
    the mix's arrivals offer them, until ``seconds`` have passed (and the
    traced units are done), then ``after(i)`` outside the unit's time.
    Each unit's latency runs from its arrival to its return (its results
    on the host), by the host clock. Returns (units run, profiler)."""
    arrivals = Arrivals(traffic.get("arrivals", "closed"))
    prof = _Profiled(first, trace_units, device)
    span = spans(trace_units > 0)
    lat = []
    i = first
    gc.disable()   # no collector pause inside the window
    try:
        rec.window_start = t0 = time.perf_counter()
        while True:
            prof.enter(i)
            arrived = arrivals.arrive(i - first, t0)
            with span("vobench.step"):
                unit(i)
            done = time.perf_counter()
            lat.append(done - arrived)
            prof.leave(i)
            after(i)
            i += 1
            if done - t0 >= seconds and i >= prof.last:
                break
    finally:
        gc.enable()
    rec.window_s = done - t0
    rec.latency_s = lat
    rec.window_steps = i - first
    return i, prof.prof
