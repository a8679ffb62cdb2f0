"""The port's benchmark: ``bench.py``'s four passes on one CUDA card.

    python3 -m openvo_tpu_torch.tools.bench [--repeats 5] [--passes ...]

Sequence: ``bench.py``'s 64-frame synthetic corridor at KITTI size
(1242x376, ``bench.py:93-96``), rendered with ``openvo_tpu_torch.io.
synthetic`` on worker processes and cached in ``.bench_cache/`` at the
root of the checkout (git-ignored), so that each pass loads it.

Passes, each in a subprocess with its own time budget inside a global one
(``bench.py:282-316``), on ``bench.py``'s configuration (``:41-56``: SGBM
D=128, block 5, P1 200, P2 800, 5 paths; ORB 500 features, 512 slots, 8
levels):

- ``off-lat``: ``models/stereo_odometer.make_step`` one frame at a time,
  speckle off, a sync after every frame;
- ``off-tp``: ``parallel/stream.make_stream_fn(chunk=16)``, speckle off;
- ``on-lat``: as off-lat with the speckle filter on (window 100, range 2);
- ``rig``: ``parallel/rig``'s batched step over 8 cameras fed identical
  streams (``bench.py:175-197``); camera-frames a second in all.

On the card every pass replays its step, or each chunk of the stream, as
one CUDA graph (``openvo_tpu_torch/_graph.py``, JAX's ``jit`` with donated
state), on-lat's speckle filter included (its labelling is the kernel
H7); each pass's line says so in ``captured``.

Each pass makes one warm call over the sequence (the kernels' first build
or load and the graph's capture included: ``warmup_s``), then
``--repeats`` timed calls over the
whole sequence from a fresh state, each between two CUDA events with one
sync at its end; the latency passes also take each frame's host-clock
latency (a frame ends in a sync). A pass prints one ``PASS_RESULT`` line.
After every pass the parent prints a cumulative JSON line in ``bench.py``'s
format (``metric``, ``value``, ``unit``, the tracking and per-shape
fields), with ``*_warmup_s`` for ``bench.py``'s ``*_compile_s``, no
``vs_baseline``, and per pass the median and least of the repeats, their
spread (max - min) / median, the latency passes' p50 and p90 frame
latencies, peak device memory, and the card's name and power limit. The
last line printed is the cumulative one.

It runs on the card and raises without one. ``--device cpu`` (with a small
``--size`` and ``--frames``) runs the plain versions on the CPU for the
tests; its times are host-clock times of the CPU, and its line says so.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_DIR = os.path.join(ROOT, ".bench_cache")
IMG_SIZE = (1242, 376)   # KITTI odometry gray resolution
F, B = 718.0, 0.54       # KITTI-like focal length / baseline
N_FRAMES = 64
SEQ = dict(seed=0, step=0.5, yaw_rate=0.004, corridor_length=80.0,
           corridor_half_width=7.0)
RENDER_TAG = 1           # bump when the rendering changes
SGBM = {                 # bench.py:49-53
    "minDisparity": 0, "numDisparities": 128, "blockSize": 5,
    "P1": 200, "P2": 800, "disp12MaxDiff": 1, "preFilterCap": 63,
    "uniquenessRatio": 10, "speckleWindowSize": 0, "speckleRange": 0,
}
# the KITTI loader's shipped speckle setting (bench.py:54-56), as changes
# to SGBM's SGBMParams
SPECKLE = dict(speckle_window_size=100, speckle_range=2)
N_CAMERAS = 8            # bench.py:47
CHUNK = 16               # off-tp's chunk (bench.py:199-204)
# pass -> (its changes to SGBM's SGBMParams, its time budget in seconds)
PASSES = {"off-lat": ({}, 500), "off-tp": ({}, 350),
          "on-lat": (SPECKLE, 250), "rig": ({}, 300)}
GLOBAL_BUDGET = 1250
# the cumulative line's field prefix of each pass, as bench.py names them
PREFIX = {"off-lat": "latency", "off-tp": "stream", "on-lat": "speckle_on",
          "rig": "rig"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def render_pair(args):
    """Left/right images of one frame, exactly as render_stereo_sequence."""
    from openvo_tpu_torch.io.synthetic import render_view

    K, T_wc, planes, tex, img_size, baseline = args
    right_offset = np.eye(4)
    right_offset[0, 3] = baseline
    left, _ = render_view(K, T_wc, planes, tex, img_size)
    right, _ = render_view(K, T_wc @ right_offset, planes, tex, img_size)
    return left, right


def focal(img_size):
    """The rig's focal length at ``img_size``: F at KITTI width, the same
    field of view at another."""
    return F * img_size[0] / IMG_SIZE[0]


def render_sequence(workers=8, img_size=IMG_SIZE, n_frames=N_FRAMES):
    """The bench's corridor (render_stereo_sequence with bench.py's
    parameters), uint8, one frame at a time on ``workers`` processes."""
    from openvo_tpu_torch.io import synthetic as syn

    rng = np.random.default_rng(SEQ["seed"])
    tex = syn.make_texture(rng)
    planes = syn.corridor_planes(SEQ["corridor_length"],
                                 SEQ["corridor_half_width"])
    K, dist, R, T = syn.make_rig(img_size, focal(img_size), B)
    poses = syn.camera_trajectory(n_frames, SEQ["step"], SEQ["yaw_rate"])
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(max(1, min(workers, n_frames,
                             multiprocessing.cpu_count()))) as pool:
        pairs = pool.map(render_pair,
                         [(K, pose, planes, tex, img_size, B)
                          for pose in poses])
    u8 = [np.clip(np.stack(v), 0, 255).astype(np.uint8) for v in zip(*pairs)]
    return {"left": u8[0], "right": u8[1], "T_wc": poses, "K": K,
            "dist": dist, "R": R, "T": T}


def get_sequence(img_size=IMG_SIZE, n_frames=N_FRAMES, cache_dir=CACHE_DIR):
    """:func:`render_sequence`, from its cache in ``cache_dir`` when there
    is one, else rendered and cached there."""
    path = os.path.join(cache_dir, f"corridor_{img_size[0]}x{img_size[1]}_"
                                   f"{n_frames}_r{RENDER_TAG}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    seq = render_sequence(img_size=img_size, n_frames=n_frames)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **seq)
    os.replace(tmp, path)
    return seq


def sgbm_params(changes=None):
    """SGBM's SGBMParams with ``changes`` to its fields."""
    from openvo_tpu_torch.models.stereo_camera import _sgbm_params_from_dict

    return dataclasses.replace(_sgbm_params_from_dict(SGBM),
                               **(changes or {}))


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ate(c_T_w, T_wc):
    """Mean camera-position error (m) of world-in-camera poses (N, 4, 4)
    against the ground truth's camera-in-world poses."""
    poses = np.linalg.inv(np.asarray(c_T_w, np.float64))
    return float(np.mean(np.linalg.norm(poses[:, :3, 3] - T_wc[:, :3, 3],
                                        axis=1)))


def run_pass(tag, args):
    """One pass in this process; prints its PASS_RESULT line."""
    import torch

    from openvo_tpu_torch import OdometerConfig, StereoCamera
    from openvo_tpu_torch._graph import capture
    from openvo_tpu_torch.models.stereo_odometer import init_state, make_step
    from openvo_tpu_torch.parallel.rig import init_rig_state, make_rig_step
    from openvo_tpu_torch.parallel.stream import make_stream_fn

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device (pass --device cpu to run "
                           "the plain versions on the CPU)")
    seq = get_sequence(img_size=args.size, n_frames=args.frames,
                       cache_dir=args.cache)
    n = args.frames
    cam = StereoCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                       {"R": seq["R"], "T": seq["T"]},
                       sgbm_params(PASSES[tag][0]), args.size,
                       device=args.device)
    cfg = OdometerConfig()
    dev = cam.device
    lefts = torch.as_tensor(seq["left"], device=dev)
    rights = torch.as_tensor(seq["right"], device=dev)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def fresh():
        return init_state(cam.cropped_shape, cfg.orb.max_keypoints, dev)

    # on the card each step replays a CUDA graph (JAX's jit); a captured
    # step's outputs live until its next call, so the runs below copy what
    # they keep
    captured = cuda

    def compiled(step):
        return capture(step) if captured else step

    if tag == "rig":
        step = compiled(make_rig_step(cam, cfg))
        # identical streams, on the card before the run
        rig_l = lefts[:, None].expand(-1, N_CAMERAS, -1, -1).contiguous()
        rig_r = rights[:, None].expand(-1, N_CAMERAS, -1, -1).contiguous()

        def run(latencies):
            state, oks, ctws = init_rig_state(cam, cfg, N_CAMERAS), [], []
            for i in range(n):
                state, ok, _ = step(state, rig_l[i], rig_r[i])
                oks.append(ok.clone())
                ctws.append(state.c_T_w.clone())
            return torch.stack(oks), torch.stack(ctws)
        work = n * N_CAMERAS
    elif tag == "off-tp":
        stream = make_stream_fn(cam, cfg, chunk=min(CHUNK, n))

        def run(latencies):
            return stream(fresh(), lefts, rights)[1]
        work = n
    else:
        step = compiled(make_step(cam, cfg, False))

        def run(latencies):
            state, oks, ctws = fresh(), [], []
            for i in range(n):
                t0 = time.perf_counter()
                state, ok, _ = step(state, lefts[i], rights[i])
                sync()
                latencies.append(time.perf_counter() - t0)
                oks.append(ok.clone())
                ctws.append(state.c_T_w.clone())
            return torch.stack(oks), torch.stack(ctws)
        work = n

    t0 = time.perf_counter()
    warm = run([])
    sync()
    warmup_s = time.perf_counter() - t0
    if tag == "off-tp":
        captured = stream.captured
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ms, lat, runs = [], [], []
    for _ in range(args.repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run(lat)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = run(lat)
            ms.append((time.perf_counter() - t0) * 1e3)
        runs.append(out)
    ok, ctw = (x.cpu().numpy() for x in runs[-1])
    agree = all(torch.equal(a[0], warm[0]) and torch.equal(a[1], warm[1])
                for a in runs)
    if tag == "rig":   # every camera saw the same stream: camera 0's
        same = bool((ok == ok[:, :1]).all())
        ok, ctw = ok[:, 0], ctw[:, 0]
    else:
        same = None
    med = float(np.median(ms))
    r = {"tag": tag, "device": (torch.cuda.get_device_name(0) if cuda
                                else "cpu"),
         "timer": "cuda events" if cuda else "host clock (CPU)",
         "captured": bool(captured),
         "frames": n, "work": work, "repeats": args.repeats,
         "ms_each": ms, "ms_median": med, "ms_min": min(ms),
         "ms_max": max(ms),
         "spread": (max(ms) - min(ms)) / med, "fps": work / med * 1e3,
         "fps_best": work / min(ms) * 1e3, "warmup_s": warmup_s,
         "tracked": int(ok.sum()),
         "skipped": [int(i) for i in np.nonzero(~ok.astype(bool))[0]],
         "ate": ate(ctw, seq["T_wc"][:n]),
         "path_len": SEQ["step"] * (n - 1), "repeats_agree": bool(agree),
         "peak_mib": (torch.cuda.max_memory_allocated() / 2 ** 20 if cuda
                      else None)}
    if same is not None:
        r["cameras_agree"] = same
    if lat:
        lat_ms = np.asarray(lat) * 1e3
        r["p50_ms"] = float(np.percentile(lat_ms, 50))
        r["p90_ms"] = float(np.percentile(lat_ms, 90))
    print("PASS_RESULT " + json.dumps(r), flush=True)


def cumulative(results, args, smi):
    """The cumulative line of the completed passes, in bench.py's format."""
    cuda = args.device == "cuda"
    shapes = [(s, results[t]) for s, t in (("latency", "off-lat"),
                                           ("stream", "off-tp"))
              if t in results]
    out = {"metric": "stereo_vo_throughput_kitti_res",
           "unit": "frames/sec/card" if cuda else "frames/sec (CPU, plain "
                                                  "versions)",
           "card": smi, "size": list(args.size), "repeats": args.repeats}
    if shapes:
        head_shape, head = max(shapes, key=lambda sr: sr[1]["fps"])
        out.update(value=head["fps"], headline_shape=head_shape,
                   tracked_frames=head["tracked"], total_frames=args.frames,
                   ate_m=head["ate"],
                   ate_pct_of_path=100 * head["ate"] / head["path_len"])
    else:
        out.update(value=0.0, error="no speckle-off pass completed")
    for tag, key in PREFIX.items():
        r = results.get(tag)
        out[f"{key}_fps"] = None if r is None else r["fps"]
        if r is None:
            continue
        for field in ("captured", "warmup_s", "ms_median", "ms_min",
                      "spread", "peak_mib", "p50_ms", "p90_ms"):
            if field in r:
                out[f"{key}_{field}"] = r[field]
    if "on-lat" in results:
        out["speckle_on_tracked"] = results["on-lat"]["tracked"]
        out["speckle_on_ate_m"] = results["on-lat"]["ate"]
    if "rig" in results:
        out["rig_fps_aggregate"] = out.pop("rig_fps")
        out["rig_n_cameras"] = N_CAMERAS
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--passes", default=",".join(PASSES))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--size", default=f"{IMG_SIZE[0]}x{IMG_SIZE[1]}",
                   help="frame width x height")
    p.add_argument("--frames", type=int, default=N_FRAMES)
    p.add_argument("--cache", default=CACHE_DIR,
                   help="directory of the rendered corridor")
    p.add_argument("--budget", type=int, default=GLOBAL_BUDGET,
                   help="seconds for all passes together")
    p.add_argument("--one", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    args.size = tuple(int(v) for v in args.size.split("x"))
    args.passes = [t for t in args.passes.split(",") if t]
    unknown = set(args.passes) - set(PASSES)
    if unknown or args.repeats < 1:
        p.error(f"unknown passes {sorted(unknown)} or repeats < 1")
    return args


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.one:
        run_pass(args.one, args)
        return 0
    smi = None
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("bench: no CUDA device (pass --device cpu to "
                               "run the plain versions on the CPU)")
        smi = card()
        log(f"bench on {smi}")
    t0 = time.perf_counter()
    get_sequence(img_size=args.size, n_frames=args.frames,
                 cache_dir=args.cache)
    log(f"[sequence] {args.frames} frames at {args.size} in "
        f"{time.perf_counter() - t0:.1f} s")
    results = {}
    t_start = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    for tag in args.passes:
        remaining = args.budget - (time.perf_counter() - t_start)
        budget = min(PASSES[tag][1], remaining)
        if budget < 30:
            log(f"[{tag}] skipped: {remaining:.0f} s of the budget left")
            continue
        cmd = [sys.executable, "-m", "openvo_tpu_torch.tools.bench",
               "--one", tag, "--repeats", str(args.repeats), "--device",
               args.device, "--size", f"{args.size[0]}x{args.size[1]}",
               "--frames", str(args.frames), "--cache", args.cache]
        t0 = time.perf_counter()
        try:
            p = subprocess.run(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                               stderr=sys.stderr, text=True, timeout=budget)
            text = p.stdout
            if p.returncode:
                log(f"[{tag}] exited with {p.returncode}")
        except subprocess.TimeoutExpired as e:
            log(f"[{tag}] timed out after {time.perf_counter() - t0:.0f} s")
            text = e.stdout or ""
            text = text.decode() if isinstance(text, bytes) else text
        for line in text.splitlines():
            if line.startswith("PASS_RESULT "):
                results[tag] = json.loads(line[len("PASS_RESULT "):])
                print(line, flush=True)
        if tag not in results:
            log(f"[{tag}] no result")
        print(json.dumps(cumulative(results, args, smi)), flush=True)
    return 0 if set(results) == set(args.passes) else 1


if __name__ == "__main__":
    sys.exit(main())
