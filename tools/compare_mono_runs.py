#!/usr/bin/env python3
"""The port's MonoOdometer on chip_smoke.py's `mono` path, run three ways
and held frame by frame against the JAX package's poses, the ground truth
and each other.

    python3 tools/compare_mono_runs.py

Renders chip_smoke.py's 64-frame corridor at 1242x376 and replays JAX's
draws (tools/jax_mono_reference.npz) in three runs:

- ``cpu``: the port on the CPU; every SVD by torch's LAPACK;
- ``cuda``: the port on the card, as the smoke's `mono` runs it; every SVD
  by the Jacobi kernel H11 (``pose/kabsch.svd``);
- ``cuda-cpu-svd``: the port on the card with every SVD of ``pose/`` (the
  five-point null space, the 8-point refit, recoverPose's decomposition of
  E) computed by the CPU's LAPACK and copied back.

The five-point null-space basis is unique only up to a rotation in 4-D,
so each backend gives its own basis and so its own float32 noise in the
candidates. If the card's run departs from the CPU's only through the
SVD's backend, ``cuda-cpu-svd`` agrees with ``cpu`` frame by frame. For
each run against JAX and the ground truth, and for each pair of runs, the
script prints the median rotation and translation-direction gaps of each
frame's motion, the frames whose direction is more than 0.1 rad off, and
the direction gaps at every frame that is off in any comparison.

Then, on the card, each stage of a frame (ORB's ``detect_and_compute``,
the ratio-test match, 5-point RANSAC, recoverPose, the rest) over 8
frames: its kernel launches, copies and synchronizing calls a frame under
torch.profiler ranges, and its ms a frame on the host clock with the card
synchronized around each stage (a separate pass). The card's runs are
eager (``_graph.disable_capture()``): a captured update is one graph
replay, with no stages to time and no host SVD. The last line is a JSON
object of all of it. Needs one card; ~5 min.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from openvo_tpu_torch import _graph  # noqa: E402
from openvo_tpu_torch.models import mono_odometer as mono  # noqa: E402
from openvo_tpu_torch.pose import fivepoint, kabsch, ransac  # noqa: E402

OFF = 0.1          # rad: a frame whose direction is further off is listed
STAGES = ("detect_and_compute", "ratio_test_match", "ransac_essential_5pt",
          "recover_pose")
PROFILED = 8
DEVICE = "cuda"


def replay(seq, ref, device):
    """Camera-in-world poses (N, 4, 4) of the port's run with JAX's draws."""
    odo = mono.MonoOdometer(seq["K"], device=device)
    us = torch.from_numpy(ref["mono_u"]).to(device)
    poses = []
    t0 = time.perf_counter()
    for i in range(cs.N_FRAMES):
        odo.update(seq["left"][i], trans_scale=cs.SEQ["step"], u=us[i])
        poses.append(odo.current_pose())
    cs.log(f"[{device}] {cs.N_FRAMES} frames in "
           f"{time.perf_counter() - t0:.1f} s")
    return np.stack(poses)


def svd_on_cpu(svd):
    def cpu_svd(a, full_matrices=True):
        return tuple(t.to(a.device) for t in svd(a.cpu(), full_matrices))
    return cpu_svd


def replay_with_cpu_svd(seq, ref):
    """``replay`` on the card with every SVD of pose/ on the CPU."""
    saved = kabsch.svd
    mods = (kabsch, ransac, fivepoint)
    for m in mods:
        m.svd = svd_on_cpu(saved)
    try:
        return replay(seq, ref, DEVICE)
    finally:
        for m in mods:
            m.svd = saved


def gaps(poses, other):
    rot, ang = cs.motion_gaps(poses, other)
    return rot, ang, {"rot_median_rad": float(np.median(rot)),
                      "dir_median_rad": float(np.median(ang)),
                      "frames_off": np.nonzero(ang > OFF)[0].tolist()}


def compare(runs):
    """Every run and JAX against the ground truth, every run against JAX,
    every pair of runs."""
    pairs = [(a, "gt") for a in runs if a != "gt"]
    pairs += [(a, "jax") for a in runs if a not in ("gt", "jax")]
    names = [a for a in runs if a not in ("gt", "jax")]
    pairs += [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]
    out, angs = {}, {}
    for a, b in pairs:
        _, angs[(a, b)], out[f"{a} vs {b}"] = gaps(runs[a], runs[b])
        gt = runs["gt"]
        if b == "gt":
            out[f"{a} vs {b}"]["ate_m"] = float(np.mean(np.linalg.norm(
                runs[a][:, :3, 3] - gt[:, :3, 3], axis=1)))
        cs.log(f"{a} vs {b}: {out[f'{a} vs {b}']}")
    off = sorted({i for v in out.values() for i in v["frames_off"]})
    table = {f"{a} vs {b}": [round(float(ang[i]), 6) for i in off]
             for (a, b), ang in angs.items()}
    cs.log(f"direction gaps (rad) at frames {off}:")
    for k, v in table.items():
        cs.log(f"  {k:28s} {v}")
    return {"comparisons": out, "frames": off, "direction_gaps": table}


def stage_costs(seq, ref):
    """Launches, copies and syncs a frame by stage under profiler ranges,
    then ms a frame by stage with the card synchronized around each."""
    odo = mono.MonoOdometer(seq["K"], device=DEVICE)
    us = torch.from_numpy(ref["mono_u"]).to(DEVICE)
    saved = {n: getattr(mono, n) for n in STAGES}
    ms = collections.defaultdict(list)

    def ranged(n, fn):
        def run(*a, **k):
            with torch.profiler.record_function(n):
                return fn(*a, **k)
        return run

    def timed(n, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            ms[n].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def frames(first):
        for i in range(first, first + PROFILED):
            odo.update(seq["left"][i], trans_scale=cs.SEQ["step"], u=us[i])

    frames(0)                                   # warm-up
    for n, fn in saved.items():
        setattr(mono, n, ranged(n, fn))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            frames(PROFILED)
            torch.cuda.synchronize()
        for n, fn in saved.items():
            setattr(mono, n, timed(n, fn))
        t0 = time.perf_counter()
        frames(2 * PROFILED)
        whole = (time.perf_counter() - t0) * 1e3 / PROFILED
    finally:
        for n, fn in saved.items():
            setattr(mono, n, fn)
    evs = [e for e in prof.events() if e.device_type.name == "CPU"]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in evs
             if e.name in STAGES]
    counts = collections.defaultdict(collections.Counter)
    for e in evs:
        kind = next((k for k in ("LaunchKernel", "Synchronize", "Memcpy")
                     if k in e.name), None)
        if kind is None:
            continue
        stage = next((n for s, t, n in spans
                      if s <= e.time_range.start <= t), "rest")
        counts[stage][kind] += 1
    out = {n: {k: v / PROFILED for k, v in counts[n].items()}
           for n in (*STAGES, "rest")}
    for n in STAGES:
        out[n]["ms_synced"] = float(np.mean(ms[n]))
    out["rest"]["ms_synced"] = whole - sum(out[n]["ms_synced"]
                                           for n in STAGES)
    out["update_ms_synced"] = whole
    for n, v in out.items():
        cs.log(f"[stages] {n}: {v}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(smi)
    ref = cs.jax_reference()
    seq = cs.render_sequence()
    with _graph.disable_capture():
        runs = {"gt": np.asarray(seq["T_wc"], np.float64),
                "jax": np.linalg.inv(ref["mono_c_T_w"][:cs.N_FRAMES].astype(
                    np.float64)),
                "cpu": replay(seq, ref, "cpu"),
                "cuda": replay(seq, ref, DEVICE),
                "cuda-cpu-svd": replay_with_cpu_svd(seq, ref)}
        result = compare(runs)
        result["stages"] = stage_costs(seq, ref)
    result["device"] = smi
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
