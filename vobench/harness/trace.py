"""Readings of a ``torch.profiler`` trace of the window's traced span: the
device's busy time (the union of its operations' intervals), the kernels
launched, the operations that took the most time and the longest idle
stretches by what the host was doing."""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

SPAN = "vobench.step"   # the harness's span around one unit of the window
NAME_CHARS = 120        # a kernel's name as the breakdown gives it


@dataclasses.dataclass
class Trace:
    window_s: float                 # first traced unit's start to last end
    busy_s: float                   # union of device operations in it
    kernels: int                    # CUDA kernels started in it
    units: int                      # traced units (steps or chunks)
    device_ops: list                # [[name, seconds]] most time first
    idle_gaps: list                 # [[harness span/host op, seconds]]


def _union(iv):
    """Merged (start, end) intervals of sorted ``iv``."""
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(prof, top: int = 10) -> Trace | None:
    """The trace's readings, None where it holds no device operation."""
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == SPAN and e.device_type != cuda]
    # the profiler mirrors the harness's spans on the device's timeline
    dev = [e for e in events if e.device_type == cuda
           and not e.name.startswith("vobench.")]
    if not spans or not dev:
        return None
    w0, w1 = min(s for s, _ in spans), max(e for _, e in spans)
    iv = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1))
                for e in dev if e.time_range.end > w0
                and e.time_range.start < w1)
    merged = _union(iv)
    busy = sum(e - s for s, e in merged)
    by_name = collections.Counter()
    kernels = 0
    for e in dev:
        if w0 <= e.time_range.start < w1:
            by_name[e.name[:NAME_CHARS]] += (
                e.time_range.end - e.time_range.start) * 1e-6
            kernels += not e.name.startswith(("Memcpy", "Memset"))
    gaps = [(s1 - e0, e0, s1) for (_, e0), (s1, _) in zip(merged, merged[1:])]
    if merged:
        gaps += [(merged[0][0] - w0, w0, merged[0][0]),
                 (w1 - merged[-1][1], merged[-1][1], w1)]
    gaps.sort(reverse=True)
    host = [e for e in events if e.device_type != cuda]
    hs = np.array([e.time_range.start for e in host])
    he = np.array([e.time_range.end for e in host])
    idle = collections.Counter()
    for length, a, b in gaps[:200]:
        mid = 0.5 * (a + b)
        inside = np.nonzero((hs <= mid) & (he >= mid))[0]
        span = [host[j] for j in inside if host[j].name.startswith(
            "vobench.") and host[j].name != SPAN]
        ops = [host[j] for j in inside if not host[j].name.startswith(
            "vobench.")]
        label = "/".join(
            min(group, key=lambda e: e.time_range.end - e.time_range.start
                ).name if group else blank
            for group, blank in ((span, "(no span)"), (ops, "(python)")))
        idle[label] += length * 1e-6
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                 kernels=kernels, units=len(spans),
                 device_ops=[[n, s] for n, s in by_name.most_common(top)],
                 idle_gaps=[[n, s] for n, s in idle.most_common(top)])
