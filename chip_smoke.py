#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final line:

1. build the CUDA kernels (openvo_tpu_torch/csrc) with nvcc;
2. at KITTI shapes (1242x376, D=128, K=512), on frame 0 of the bench
   sequence, run each kernel and each of its variants and its plain
   PyTorch version on the card, require bit-equal outputs, and time both
   with CUDA events; also hold the speckle filter on the card against the
   same function on the CPU, and time block13's plain cost volume;
3. run StereoOdometer.update over the 64-frame bench sequence (the
   corridor of bench.py, rendered here with numpy) on the card in five
   SGBM configurations (PATHS), with the plain versions disabled, and
   check tracking, ATE and that every kernel of each path launched once
   per frame.

The second-to-last lines are a JSON object with one entry per kernel
variant on a path (and the variants checked outside any path under
"checks") and the card's name and power limit from nvidia-smi; the last
line is {"ok": true, "device": {...}}. Needs no network and imports no JAX.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import multiprocessing
import subprocess
import sys
import time

import numpy as np

IMG_SIZE = (1242, 376)   # KITTI odometry gray resolution
F, B = 718.0, 0.54       # KITTI-like focal length / baseline
N_FRAMES = 64
SEQ = dict(seed=0, step=0.5, yaw_rate=0.004, corridor_length=80.0,
           corridor_half_width=7.0)
SGBM = {                 # bench.py:49-53, the off-lat pass
    "minDisparity": 0, "numDisparities": 128, "blockSize": 5,
    "P1": 200, "P2": 800, "disp12MaxDiff": 1, "preFilterCap": 63,
    "uniquenessRatio": 10, "speckleWindowSize": 0, "speckleRange": 0,
}
# The paths of phase 3: name -> (changes to SGBM's SGBMParams, whether the
# bench's tracking bar holds).
PATHS = {
    "off-lat": ({}, True),
    "on-lat": (dict(speckle_window_size=100, speckle_range=2), True),  # :56
    "hh8": (dict(num_paths=8), False),
    "hv4": (dict(num_paths=4), False),
    # no int16 sentinel at preFilterCap 63
    "block13": (dict(block_size=13, p1=8 * 169, p2=32 * 169), False),
}
DEVICE = "cuda"
MIN_TRACKED = 63
MAX_ATE_M = 1.25
SGBM_SRC = "openvo_tpu_torch/csrc/sgbm.cu"
PALLAS_SGBM = "openvo_tpu/ops/sgbm_pallas.py"
K1 = f"{PALLAS_SGBM}:305"
K2 = f"{PALLAS_SGBM}:478"
K3_K4 = f"{PALLAS_SGBM}:1002 + {PALLAS_SGBM}:827"
K6 = f"{PALLAS_SGBM}:115"
K7_K4 = f"{PALLAS_SGBM}:716 + {PALLAS_SGBM}:827"


def log(*a):
    print(*a, flush=True)


def _render_pair(args):
    """Left/right images of frame i, exactly as render_stereo_sequence."""
    from openvo_tpu_torch.io.synthetic import render_view

    K, T_wc, planes, tex, img_size, baseline = args
    right_offset = np.eye(4)
    right_offset[0, 3] = baseline
    left, _ = render_view(K, T_wc, planes, tex, img_size)
    right, _ = render_view(K, T_wc @ right_offset, planes, tex, img_size)
    return left, right


def render_sequence():
    """The bench's 64-frame corridor (render_stereo_sequence with bench.py's
    parameters), one frame per worker process."""
    from openvo_tpu_torch.io import synthetic as syn

    rng = np.random.default_rng(SEQ["seed"])
    tex = syn.make_texture(rng)
    planes = syn.corridor_planes(SEQ["corridor_length"],
                                 SEQ["corridor_half_width"])
    K, dist, R, T = syn.make_rig(IMG_SIZE, F, B)
    poses = syn.camera_trajectory(N_FRAMES, SEQ["step"], SEQ["yaw_rate"])
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(8, multiprocessing.cpu_count())) as pool:
        pairs = pool.map(_render_pair,
                         [(K, pose, planes, tex, IMG_SIZE, B)
                          for pose in poses])
    u8 = [np.clip(np.stack(v), 0, 255).astype(np.uint8) for v in zip(*pairs)]
    return {"left": u8[0], "right": u8[1], "T_wc": poses, "K": K,
            "dist": dist, "R": R, "T": T}


def path_params(name):
    from openvo_tpu_torch.models.stereo_camera import _sgbm_params_from_dict

    return dataclasses.replace(_sgbm_params_from_dict(SGBM), **PATHS[name][0])


def time_ms(torch, fn, reps):
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
                             f"{tuple(b.shape)} {b.dtype}")
    return float((a.double() - b.double()).abs().max())


def kernel_cases(torch, seq, cam, cfg):
    """Phase 2's cases: (name, variant, path or None, kernel call, plain
    call, replaces), all at KITTI shapes on frame 0."""
    from openvo_tpu_torch.ops import orb, orb_cuda, sgbm, sgbm_cuda as sc
    from openvo_tpu_torch.ops.remap import remap_bilinear

    dev = cam.device
    p = cam.sgbm
    cap = max(p.pre_filter_cap, 15) | 1
    left = torch.as_tensor(seq["left"][0], device=dev).to(torch.float32)
    right = torch.as_tensor(seq["right"][0], device=dev).to(torch.float32)

    def prefiltered(shift):
        (lx, ly), (rx, ry) = cam.map_left, cam.map_right
        return (sgbm.prefilter_xsobel(
                    remap_bilinear(left, lx + shift, ly + shift), cap),
                sgbm.prefilter_xsobel(
                    remap_bilinear(right, rx + shift, ry + shift), cap))

    lp, rp = prefiltered(0.0)
    # frame 0 resampled by a fractional shift: every pixel fractional
    lpf, rpf = prefiltered(0.37)
    if torch.equal(lpf, torch.round(lpf)):
        raise AssertionError("the shifted pair is not fractional")
    p1, p2 = 2 * p.effective_p1, 2 * p.effective_p2
    h1 = (p.min_disparity, p.num_disparities, p.block_size,
          sgbm.int16_sentinel(p.block_size, cap), p1, p2, True)
    C, s1 = sc.cost_hsweep(lp, rp, *h1)
    sv = sc.vsweep(C, p1, p2, True)
    wta = (p1, p2, p.min_disparity, p.uniqueness_ratio, p.disp12_max_diff)

    q = path_params("block13")
    q1, q2 = 2 * q.effective_p1, 2 * q.effective_p2
    if sgbm.int16_sentinel(q.block_size, cap) is not None:
        raise AssertionError("block13 has an int16 sentinel")
    C32 = sc.cost_volume(lp, rp, q.min_disparity, q.num_disparities,
                         q.block_size, 8 * cap, True)
    s1_32 = sc.hsweep(C32, q1, q2)
    sv32 = sc.vsweep(C32, q1, q2, True)
    wta13 = (q1, q2, q.min_disparity, q.uniqueness_ratio, q.disp12_max_diff)

    h48 = (p.min_disparity, 48) + h1[2:]

    def chain(cost_fn, vsweep_fn, wta_fn):
        def run():
            C48, s148 = cost_fn(lp, rp, *h48)
            return wta_fn(C48, s148, vsweep_fn(C48, p1, p2, True), *wta)
        return run

    _, disp_f, img = cam.compute_3d_fn(False, False)(
        torch.as_tensor(seq["left"][0], device=dev),
        torch.as_tensor(seq["right"][0], device=dev))
    fmask = ((disp_f >= cfg.min_valid_disparity)
             & (disp_f <= cfg.max_valid_disparity)).to(torch.uint8)
    det = orb.detect(img, fmask, cfg.orb)
    wins, ip, iq, _ = orb.descriptor_inputs(det)
    kp_valid = det["valid"]

    def vs(diag, down, up, cost=C, pen=(p1, p2)):
        return (lambda: sc.vsweep(cost, *pen, diag, down, up),
                lambda: sc.vsweep_plain(cost, *pen, diag, down, up))

    return [
        ("cost_hsweep", "int16 C, integer pair", "off-lat",
         lambda: sc.cost_hsweep(lp, rp, *h1),
         lambda: sc.cost_hsweep_plain(lp, rp, *h1), K1),
        ("cost_hsweep", "int16 C, non-integer pair (bf16 cost)", None,
         lambda: sc.cost_hsweep(lpf, rpf, *h1),
         lambda: sc.cost_hsweep_plain(lpf, rpf, *h1), K1),
        ("vsweep", "down trio, int16 C (5 paths)", "off-lat",
         *vs(True, True, False), K2),
        ("vsweep", "down and up trios, int16 C (8 paths)", "hh8",
         *vs(True, True, True), K2),
        ("vsweep", "vertical down and up, int16 C (4 paths)", "hv4",
         *vs(False, True, True), K2),
        ("vsweep", "up trio, int16 C", None, *vs(True, False, True), K2),
        ("vsweep", "vertical down, int16 C", None, *vs(False, True, False),
         K2),
        ("vsweep", "vertical up, int16 C", None, *vs(False, False, True), K2),
        ("vsweep", "down trio, int32 C (block13)", "block13",
         *vs(True, True, False, C32, (q1, q2)), K2),
        ("hsweep", "forward, int32 C (block13)", "block13",
         lambda: sc.hsweep(C32, q1, q2),
         lambda: sc.hsweep_plain(C32, q1, q2), K6),
        ("hsweep", "reverse with accumulator, int32 C", None,
         lambda: sc.hsweep(C32, q1, q2, True, s1_32),
         lambda: sc.hsweep_plain(C32, q1, q2, True, s1_32), K6),
        ("hsweep_wta_lr", "int16 C", "off-lat",
         lambda: sc.hsweep_wta_lr(C, s1, sv, *wta),
         lambda: sc.hsweep_wta_lr_plain(C, s1, sv, *wta), K3_K4),
        ("hsweep_wta_lr", "int32 C (block13)", "block13",
         lambda: sc.hsweep_wta_lr(C32, s1_32, sv32, *wta13),
         lambda: sc.hsweep_wta_lr_plain(C32, s1_32, sv32, *wta13), K7_K4),
        ("cost_hsweep+vsweep+hsweep_wta_lr", "D=48, blocks of 64 threads",
         None, chain(sc.cost_hsweep, sc.vsweep, sc.hsweep_wta_lr),
         chain(sc.cost_hsweep_plain, sc.vsweep_plain,
               sc.hsweep_wta_lr_plain), f"{K1}, {K2}, {K3_K4}"),
        ("brief_describe", "K=512", "off-lat",
         lambda: orb_cuda.brief_describe(wins, ip, iq, kp_valid),
         lambda: orb_cuda.brief_describe_plain(wins, ip, iq, kp_valid),
         "openvo_tpu/ops/orb_pallas.py:60"),
    ]


def check_kernels(torch, seq, cam, cfg):
    """Phase 2: each kernel variant against its plain version."""
    results = []
    cases = kernel_cases(torch, seq, cam, cfg)
    for name, variant, path, kern, plain, replaces in cases:
        out, ref = kern(), plain()
        out = out if isinstance(out, tuple) else (out,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = max(max_abs_err(a, b) for a, b in zip(out, ref))
        log(f"[kernels] {name} [{variant}]: shapes "
            f"{[tuple(o.shape) for o in out]}, max_abs_err vs plain {err}")
        if err != 0.0:
            raise AssertionError(f"{name} [{variant}] differs from its "
                                 f"plain version")
        src = ("openvo_tpu_torch/csrc/orb.cu" if name == "brief_describe"
               else SGBM_SRC)
        results.append({"name": name, "variant": variant, "path": path,
                        "route": "cuda", "source": src, "replaces": replaces,
                        "max_abs_err": err})
    # times: plain, kernel, kernel, plain, each by CUDA events
    for r, (name, _, _, kern, plain, _) in zip(results, cases):
        reps_plain = 20 if name == "brief_describe" else 1
        t_p1 = time_ms(torch, plain, reps_plain)
        t_k1 = time_ms(torch, kern, 20)
        t_k2 = time_ms(torch, kern, 20)
        t_p2 = time_ms(torch, plain, reps_plain)
        r["ms"] = min(t_k1, t_k2)
        r["plain_ms"] = min(t_p1, t_p2)
        log(f"[kernels] {name} [{r['variant']}]: kernel {t_k1:.4f} / "
            f"{t_k2:.4f} ms, plain {t_p1:.4f} / {t_p2:.4f} ms")
    return results


def check_plain_stages(torch, seq, cam):
    """The plain PyTorch stages of the paths, on frame 0: the speckle
    filter on the card against the same function on the CPU (on-lat's
    disparity before the filter), and the time of block13's int32 cost
    volume and box sum."""
    from openvo_tpu_torch.ops import sgbm, sgbm_cuda
    from openvo_tpu_torch.ops.remap import remap_bilinear

    p = path_params("on-lat")
    unfiltered = dataclasses.replace(p, speckle_window_size=0)
    left, right = (
        remap_bilinear(torch.as_tensor(seq[side][0], device=cam.device)
                       .to(torch.float32), *maps)
        for side, maps in (("left", cam.map_left), ("right", cam.map_right)))
    d16 = sgbm.sgbm_disparity16(left, right, unfiltered)
    valid = d16 != (p.min_disparity - 1) * 16
    sgbm.speckle_filter.syncs = 0
    keep = sgbm.speckle_filter(d16, valid, p)
    syncs = sgbm.speckle_filter.syncs
    keep_cpu = sgbm.speckle_filter(d16.cpu(), valid.cpu(), p)
    if not torch.equal(keep.cpu(), keep_cpu):
        raise AssertionError("the speckle mask on the card differs from the "
                             "CPU's")
    ms = time_ms(torch, lambda: sgbm.speckle_filter(d16, valid, p), 5)
    removed = int(valid.sum() - keep.sum())
    log(f"[speckle] frame 0: mask equal to the CPU's; {removed} of "
        f"{int(valid.sum())} valid pixels removed; {syncs} host syncs; "
        f"{ms:.4f} ms on the card")
    q = path_params("block13")
    cap = max(q.pre_filter_cap, 15) | 1
    lp, rp = sgbm.prefilter_xsobel(left, cap), sgbm.prefilter_xsobel(right,
                                                                     cap)
    cost_args = (lp, rp, q.min_disparity, q.num_disparities, q.block_size,
                 8 * cap, True)
    gc.collect()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cost_ms = time_ms(torch, lambda: sgbm_cuda.cost_volume(*cost_args), 5)
    cost_mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    log(f"[cost_volume] block13's int32 cost volume and box sum: "
        f"{cost_ms:.4f} ms on the card, {cost_mib:.1f} MiB at its peak")
    return [{"name": "speckle_filter", "variant": "plain PyTorch",
             "route": "torch", "source": "openvo_tpu_torch/ops/sgbm.py",
             "replaces": "openvo_tpu/ops/sgbm.py:498 (XLA, no Pallas "
                         "kernel)", "max_abs_err": 0.0, "ms": ms,
             "host_syncs": syncs},
            {"name": "cost_volume", "variant": "int32, block 13, plain "
             "PyTorch", "route": "torch",
             "source": "openvo_tpu_torch/ops/sgbm_cuda.py",
             "replaces": "openvo_tpu/ops/sgbm.py:555-558 (XLA)",
             "ms": cost_ms, "peak_mib": cost_mib}]


def run_path(torch, seq, name):
    """Phase 3 for one path: the odometer over the sequence with the plain
    versions disabled; returns launch counts per kernel name."""
    from openvo_tpu_torch import OdometerConfig, StereoCamera, StereoOdometer
    from openvo_tpu_torch.ops import orb_cuda, sgbm, sgbm_cuda

    kernels = sgbm_cuda.KERNELS + orb_cuda.KERNELS
    plains = {(sgbm_cuda, "cost_hsweep_plain"), (sgbm_cuda, "vsweep_plain"),
              (sgbm_cuda, "hsweep_plain"), (sgbm_cuda, "hsweep_wta_lr_plain"),
              (orb_cuda, "brief_describe_plain")}

    def tripwire(*_a, **_k):
        raise AssertionError("a plain version ran on the main path")

    params = path_params(name)
    cam = StereoCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                       {"R": seq["R"], "T": seq["T"]}, params, IMG_SIZE,
                       device=DEVICE)
    saved = {(m, n): getattr(m, n) for m, n in plains}
    for m, n in plains:
        setattr(m, n, tripwire)
    odo = StereoOdometer(cam, config=OdometerConfig())
    oks, causes, poses, lat = [], [], [], []
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    try:
        sgbm.speckle_filter.syncs = 0
        for k in kernels:
            k.launches = 0
        for i in range(N_FRAMES):
            t0 = time.perf_counter()
            oks.append(odo.update(seq["left"][i], seq["right"][i]))
            lat.append(time.perf_counter() - t0)   # update() ends in a sync
            causes.append(odo.skip_cause)
            poses.append(odo.current_pose())
        launches = {k.__name__: k.launches for k in kernels}
        syncs = sgbm.speckle_filter.syncs
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    poses = np.stack(poses)
    gt = np.asarray(seq["T_wc"], np.float64)
    ate = float(np.mean(np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3],
                                       axis=1)))
    tracked = int(sum(oks))
    skips = [(i, causes[i]) for i, ok in enumerate(oks) if not ok]
    med = float(np.median(lat[2:])) * 1e3
    log(f"[{name}] tracked {tracked}/{N_FRAMES} (skipped: {skips}), ATE "
        f"{ate} m over {SEQ['step'] * (N_FRAMES - 1)} m, per-frame update "
        f"latency median {med} ms (frames 2-{N_FRAMES - 1}), min "
        f"{min(lat[2:]) * 1e3} ms, max {max(lat[2:]) * 1e3} ms, first "
        f"frame {lat[0] * 1e3} ms; device memory allocated {base:.1f} MiB "
        f"at the start, peak {peak:.1f} MiB")
    log(f"[{name}] kernel launches: {launches}; speckle host syncs "
        f"{syncs} ({syncs / N_FRAMES} a frame)")
    if not np.isfinite(poses).all():
        raise AssertionError(f"{name}: non-finite pose")
    if PATHS[name][1] and (tracked < MIN_TRACKED or not ate <= MAX_ATE_M):
        raise AssertionError(f"{name}: tracking below bar: {tracked} "
                             f"tracked, ATE {ate}")
    no_sentinel = params.block_size == 13
    expected = {"cost_hsweep": not no_sentinel, "hsweep": no_sentinel,
                "vsweep": True, "hsweep_wta_lr": True, "brief_describe": True}
    for k, on_path in expected.items():
        if launches[k] != (N_FRAMES if on_path else 0):
            raise AssertionError(f"{name}: {k} launched {launches[k]} times "
                                 f"in {N_FRAMES} frames")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from openvo_tpu_torch import OdometerConfig, StereoCamera, _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    t0 = time.perf_counter()
    seq = render_sequence()
    log(f"[render] {N_FRAMES} frames at {IMG_SIZE} in "
        f"{time.perf_counter() - t0:.1f} s")
    cam = StereoCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                       {"R": seq["R"], "T": seq["T"]}, SGBM, IMG_SIZE,
                       device=DEVICE)
    results = check_kernels(torch, seq, cam, OdometerConfig())
    checks = [r for r in results if r["path"] is None]
    checks += check_plain_stages(torch, seq, cam)
    launches = {name: run_path(torch, seq, name) for name in PATHS}
    kernels = [r for r in results if r["path"] is not None]
    for r in kernels:
        r["launches"] = launches[r["path"]][r["name"]]
        r["launches_by_path"] = {n: c[r["name"]] for n, c in launches.items()
                                 if c[r["name"]]}
    print(json.dumps({"kernels": kernels, "checks": checks}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
