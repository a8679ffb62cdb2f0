#!/usr/bin/env python3
"""Where the port's per-frame time goes on one CUDA card.

    python3 tools/profile_torch_step.py [--frames N] [--trace OUT.json.gz]
                                        [--root CHECKOUT]

Renders the bench corridor (as chip_smoke.py), warms the odometer up on
its first frames, then for N frames times each stage of the step with CUDA
events (depth: remap + SGBM + reproject; ORB; matching + pose + state
machine) and the whole update() on the host clock, and runs one window of
frames under torch.profiler. Prints the per-stage medians, the device's
busy share of the profiled window and the ops that took the most device
time; with --trace, writes the window's gzipped Chrome trace there.

Then, on the same N frames, ORB's descriptor stage (everything that
``detect_and_compute`` does after ``detect``: orientation, H4 and what
feeds it) as the difference of the two calls, timed in turns: per frame,
the device time by CUDA events, the host time (the host clock around the
call on an idle card: the enqueue and the syncs the call makes itself),
and under torch.profiler the kernels launched, the host-to-device copies
and H4's own device time. Both calls keep their signatures across the port's
checkouts, so ``--root`` (the checkout whose ``openvo_tpu_torch`` and
``chip_smoke`` are profiled, by default this one) compares commits in one
call: run parent, change, change, parent. The last line is a JSON object
of the stage medians and the descriptor stage.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _timed(fn, img, mask):
    """(device ms by CUDA events, host ms to its return) of one call on an
    idle card."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    fn(img, mask)
    host = (time.perf_counter() - t0) * 1e3
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]), host


def orb_stage_costs(detect, detect_and_compute, inputs, reps=5):
    """ORB's descriptor stage as ``detect_and_compute`` less ``detect`` on
    each of ``inputs`` ((img, mask) pairs). The two are timed in turns,
    ``reps`` pairs a frame; each time is the median (with its quartiles)
    of the calls' or of the pairs' differences. One torch.profiler pass of
    each over the frames gives, per frame, the kernels, the host-to-device
    copies and the device ms of H4's kernel."""
    fns = {"detect": detect, "detect_and_compute": detect_and_compute}
    for fn in fns.values():
        fn(*inputs[0])                           # warm-up
    times = {k: [] for k in (*fns, "descriptor_stage")}
    for img, mask in inputs:
        for _ in range(reps):
            a, b = (_timed(fn, img, mask) for fn in fns.values())
            times["detect"].append(a)
            times["detect_and_compute"].append(b)
            times["descriptor_stage"].append((b[0] - a[0], b[1] - a[1]))
    out = {}
    for k, v in times.items():
        v = np.asarray(v)
        out[k] = {f"{what}_ms": float(np.median(v[:, i]))
                  for i, what in enumerate(("device", "host"))}
        out[k].update({f"{what}_ms_quartiles": np.percentile(
            v[:, i], [25, 75]).tolist()
            for i, what in enumerate(("device", "host"))})
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for k, fn in fns.items():
        with torch.profiler.profile(activities=acts) as prof:
            for img, mask in inputs:
                fn(img, mask)
            torch.cuda.synchronize()
        kernels = copies = 0
        h4_us = 0.0
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if "Memcpy HtoD" in e.name:
                copies += 1
            elif not e.name.startswith(("Memcpy", "Memset")):
                kernels += 1
                if "brief_describe_kernel" in e.name:
                    h4_us += e.device_time_total
        out[k].update(kernels=kernels / len(inputs),
                      htod_copies=copies / len(inputs),
                      h4_device_ms=h4_us / len(inputs) / 1e3)
    out["descriptor_stage"].update(
        {k: out["detect_and_compute"][k] - out["detect"][k]
         for k in ("kernels", "htod_copies", "h4_device_ms")})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--trace", help="write the profiled window's gzipped "
                    "Chrome trace to this path")
    ap.add_argument("--root", default=ROOT, help="the checkout to profile "
                    "(default: this one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke
    from openvo_tpu_torch import OdometerConfig, StereoCamera
    from openvo_tpu_torch.models import stereo_odometer as so
    from openvo_tpu_torch.ops import orb

    print(f"[root] {os.path.abspath(args.root)}: openvo_tpu_torch from "
          f"{os.path.dirname(orb.__file__)}")
    seq = chip_smoke.render_sequence()
    cam = StereoCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                       {"R": seq["R"], "T": seq["T"]}, chip_smoke.SGBM,
                       chip_smoke.IMG_SIZE, device="cuda")
    cfg = OdometerConfig()
    fns = so.make_pipeline_fns(cam, cfg, color=False)
    compute3d = cam.compute_3d_fn(False, False)
    detect_and_compute = orb.detect_and_compute

    state = so.init_state(cam.cropped_shape, cfg.orb.max_keypoints, "cuda")
    frames = [(torch.as_tensor(seq["left"][i], device="cuda"),
               torch.as_tensor(seq["right"][i], device="cuda"))
              for i in range(chip_smoke.N_FRAMES)]
    for left, right in frames[:4]:            # warm-up
        state, _, _ = fns["step_feats"](state, fns["extract"](left, right))
    torch.cuda.synchronize()

    stages = {"depth": [], "orb": [], "match_pose_state": [], "update": []}
    orb_inputs = []
    for left, right in frames[4:4 + args.frames]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        ev[0].record()
        xyz, disp, img = compute3d(left, right)
        ev[1].record()
        fmask = ((disp >= cfg.min_valid_disparity)
                 & (disp <= cfg.max_valid_disparity)).to(torch.uint8)
        orb_inputs.append((img, fmask))
        f = detect_and_compute(img, fmask, cfg.orb)
        ev[2].record()
        feats = so.FrameFeatures(img, xyz, disp, f["xy"], f["desc"],
                                 f["valid"])
        state, ok, _ = fns["step_feats"](state, feats)
        ev[3].record()
        bool(ok)
        torch.cuda.synchronize()
        stages["update"].append((time.perf_counter() - t0) * 1e3)
        for name, a, b in (("depth", 0, 1), ("orb", 1, 2),
                           ("match_pose_state", 2, 3)):
            stages[name].append(ev[a].elapsed_time(ev[b]))
    for name, v in stages.items():
        print(f"[stage] {name}: median {np.median(v):.3f} ms "
              f"(min {min(v):.3f}, max {max(v):.3f}) over {len(v)} frames")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    window = frames[4 + args.frames:4 + args.frames + 8]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for left, right in window:
            state, ok, _ = fns["step_feats"](state,
                                             fns["extract"](left, right))
            bool(ok)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    print(f"[profile] {len(window)} frames, wall {wall_ms:.3f} ms, device "
          f"busy {dev_us / 1e3:.3f} ms ({100 * dev_us / 1e3 / wall_ms:.1f}%)"
          f", {sum(e.count for e in events if getattr(e, 'self_device_time_total', 0) > 0)}"
          f" op calls with device time")
    print(events.table(sort_by="self_device_time_total", row_limit=25))
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        tmp = args.trace + ".json.tmp"
        prof.export_chrome_trace(tmp)
        with open(tmp, "rb") as src, gzip.open(args.trace, "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.remove(tmp)

    costs = orb_stage_costs(lambda i, m: orb.detect(i, m, cfg.orb),
                            lambda i, m: orb.detect_and_compute(i, m,
                                                                cfg.orb),
                            orb_inputs)
    for name, c in costs.items():
        print(f"[orb] {name}, a frame over {len(orb_inputs)} frames: device "
              f"{c['device_ms']:.4f} ms (quartiles "
              f"{c['device_ms_quartiles']}), host {c['host_ms']:.4f} ms "
              f"(quartiles {c['host_ms_quartiles']}), {c['kernels']:.1f} "
              f"kernels, {c['htod_copies']:.1f} host-to-device copies, H4 "
              f"device {c['h4_device_ms']:.4f} ms")
    print(json.dumps({"root": os.path.abspath(args.root),
                      "stage_median_ms": {k: float(np.median(v))
                                          for k, v in stages.items()},
                      "orb": costs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
