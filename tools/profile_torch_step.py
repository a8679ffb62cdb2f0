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
call: run parent, change, change, parent.

Last, ``detect`` in its stages, each run alone on the same frames under
torch.profiler (kernels and device ms a frame; for H6 and H9 also each
device operation apart, device copies included): the pyramid (H6), FAST's
score, the 3x3 NMS and Harris as plain PyTorch (the functions the per-pixel
stages were built from), the per-pixel stages whole as plain PyTorch
(``orb.corner_keys_plain``) and as H9 (``orb_cuda.corner_keys``) where the
checkout has them, and ``detect`` whole. The last line is a JSON object of
the stage medians, the descriptor stage and detect's stages.
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


def profiled(fn, n):
    """(CUDA kernels, their device ms, {device operation: (count, device
    ms)}) a call of fn(i), i < n, under torch.profiler, after one call to
    warm up. The last holds device-to-device copies and memsets too; the
    first two do not."""
    fn(0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    kernels, us, by_name = 0, 0.0, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if not e.name.startswith(("Memcpy", "Memset")):
            kernels += 1
            us += e.device_time_total
        if not e.name.startswith(("Memcpy HtoD", "Memcpy DtoH")):
            count, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (count + 1, t + e.device_time_total)
    return kernels / n, us / 1e3 / n, {
        k: (c / n, t / 1e3 / n) for k, (c, t) in by_name.items()}


def detect_stages(orb, orb_cuda, inputs, params):
    """ORB's ``detect`` in its stages, each alone on each of ``inputs``
    ((img, mask) pairs): kernels and device ms a frame (:func:`profiled`),
    and what ``detect`` runs beside the stages (its top-k, compaction and
    the per-pixel stages' glue) as the difference."""
    H, W = inputs[0][0].shape[-2:]
    dims = tuple(orb._level_dims(H, W, params))
    b, thr = params.edge_threshold, float(params.fast_threshold)
    imgs = [img.to(torch.float32).contiguous() for img, _ in inputs]
    masks = [(m > 0).contiguous() for _, m in inputs]
    stacks = [orb_cuda.resize_levels(img, dims) for img in imgs]
    scores = [orb.fast_score(st, thr)[0] for st in stacks]
    stages = {
        "pyramid (H6)": lambda i: orb_cuda.resize_levels(imgs[i], dims),
        "FAST score and test (plain)": lambda i: orb.fast_score(stacks[i],
                                                                thr),
        "3x3 NMS (plain)": lambda i: orb._nms3x3(scores[i]),
        "Harris (plain)": lambda i: orb.harris_response(stacks[i]),
    }
    if hasattr(orb, "corner_keys_plain"):
        stages["per-pixel stages whole (plain)"] = lambda i: (
            orb.corner_keys_plain(stacks[i], masks[i], dims, b, thr))
    if hasattr(orb_cuda, "corner_keys"):
        stages["per-pixel stages whole (H9)"] = lambda i: (
            orb_cuda.corner_keys(stacks[i], masks[i], dims, b, thr))
    stages["detect"] = lambda i: orb.detect(*inputs[i], params)
    out = {name: dict(zip(("kernels", "device_ms", "by_kernel"),
                          profiled(fn, len(inputs))))
           for name, fn in stages.items()}
    for name, c in out.items():   # each device operation of H6 and H9
        if "H6" not in name and "H9" not in name:
            del c["by_kernel"]
    per_pixel = ("per-pixel stages whole (H9)"
                 if "per-pixel stages whole (H9)" in out else None)
    parts = ["pyramid (H6)"] + ([per_pixel] if per_pixel else [
        "FAST score and test (plain)", "3x3 NMS (plain)", "Harris (plain)"])
    out["detect less " + " and ".join(parts)] = {
        k: out["detect"][k] - sum(out[p][k] for p in parts)
        for k in ("kernels", "device_ms")}
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
    seq = chip_smoke.get_sequence()
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
    kernels = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset")))
    print(f"[profile] {len(window)} frames, wall {wall_ms:.3f} ms, device "
          f"busy {dev_us / 1e3:.3f} ms ({100 * dev_us / 1e3 / wall_ms:.1f}%)"
          f", {kernels / len(window)} CUDA kernels a frame"
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
    from openvo_tpu_torch.ops import orb_cuda

    det = detect_stages(orb, orb_cuda, orb_inputs, cfg.orb)
    for name, c in det.items():
        print(f"[detect] {name}, a frame over {len(orb_inputs)} frames: "
              f"{c['kernels']:.1f} kernels, {c['device_ms']:.4f} ms of "
              f"kernel time")
        for k, (n, ms) in c.get("by_kernel", {}).items():
            print(f"[detect]   {n:.1f} x {k[:90]}: {ms:.4f} ms")
    print(json.dumps({"root": os.path.abspath(args.root),
                      "stage_median_ms": {k: float(np.median(v))
                                          for k, v in stages.items()},
                      "orb": costs, "detect_stages": det}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
