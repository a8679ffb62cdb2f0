#!/usr/bin/env python3
"""What one captured update costs on one CUDA card, path by path.

    python3 tools/replay_kernels.py [--root CHECKOUT] [--paths a,b,...]
                                    [--frames N] [--cache DIR]
                                    [--kernels name,name,...]

For each path of ``chip_smoke.PATHS`` named (``mono`` and ``mono-own``:
MonoOdometer on the left images, with JAX's draws replayed or its own),
builds the odometer as ``chip_smoke.py`` does, runs the bench corridor's
first N frames captured (each update one replayed CUDA graph), and
reports the median host-clock ``update`` latency of frames 2..N-1, then
four more updates under torch.profiler: CUDA kernels a replay and their
device ms, and that time over the host clock (the card's busy share);
with ``--kernels``, also the launches and device ms a replay of the
kernels whose names hold each given name (say ``jacobi_svd``).
``--root`` picks the checkout whose ``openvo_tpu_torch`` and
``chip_smoke`` run (this one by default), so one call can compare commits
in turns: parent, change, change, parent. A path the checkout does not
capture is reported as such. The corridor is rendered once into
``--cache``. The last line is a JSON object: the card, and per path its
latency, kernels and kernel ms.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profile(torch, fn, calls=4, names=()):
    """(kernels a call, kernel ms a call, busy share, {name: (launches a
    call, device ms a call)} of the kernels whose names hold each of
    ``names``) of fn() under torch.profiler, as
    chip_smoke.replay_profile counts them."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, device_us = 0, 0.0
    by = {n: [0, 0.0] for n in names}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith(("Memcpy", "Memset"))):
            kernels += 1
            device_us += e.device_time_total
            for n in names:
                if n in e.name:
                    by[n][0] += 1
                    by[n][1] += e.device_time_total
    return (kernels / calls, device_us / 1e3 / calls, device_us / 1e6 / wall,
            {n: (c / calls, us / 1e3 / calls) for n, (c, us) in by.items()})


def run_path(torch, cs, seq, name, frames, names=()):
    """Median captured update ms of frames 2..frames-1, then the profile of
    four more updates; None where the path does not run captured."""
    if name in ("mono", "mono-own"):
        from openvo_tpu_torch.models.mono_odometer import MonoOdometer

        us = [torch.from_numpy(u).to("cuda")
              for u in cs.jax_reference()["mono_u"]]
        odo = MonoOdometer(seq["K"], device="cuda")

        def update(i):
            return odo.update(seq["left"][i], trans_scale=cs.SEQ["step"],
                              u=us[i] if name == "mono" else None)
    else:
        from openvo_tpu_torch import StereoCamera, StereoOdometer

        cam = StereoCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                           {"R": seq["R"], "T": seq["T"]},
                           cs.path_params(name), cs.IMG_SIZE, device="cuda")
        odo = StereoOdometer(cam, **cs.odometer_kwargs(name))

        def update(i):
            return odo.update(seq["left"][i], seq["right"][i])

    lat = []
    for i in range(frames):
        t0 = time.perf_counter()
        update(i)
        lat.append((time.perf_counter() - t0) * 1e3)
        if not getattr(odo, "captured", False):
            return None
    kernels, kernel_ms, busy, by = profile(
        torch, lambda: update(frames - 1), names=names)
    return {"update_ms": float(np.median(lat[2:])), "kernels": kernels,
            "kernel_ms": kernel_ms, "busy": busy, "by_kernel": by}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT, help="the checkout to run "
                    "(its openvo_tpu_torch and chip_smoke)")
    ap.add_argument("--paths", default="off-lat,filters,mono,mono-own")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--cache", default=os.path.join(ROOT, ".bench_cache"))
    ap.add_argument("--kernels", default="", help="comma-separated names: "
                    "each one's launches and device ms a replay")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("replay_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from openvo_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    _build.library()
    print(f"[{root}] build {time.perf_counter() - t0:.1f} s; {smi}",
          flush=True)
    seq = cs.get_sequence(cache_dir=args.cache)
    out = {"root": root, "card": smi, "paths": {}}
    for name in args.paths.split(","):
        names = tuple(n for n in args.kernels.split(",") if n)
        r = run_path(torch, cs, seq, name, args.frames, names)
        out["paths"][name] = r
        print(f"[{root}] {name}: "
              + ("not captured" if r is None else
                 f"update {r['update_ms']:.3f} ms (median of frames 2-"
                 f"{args.frames - 1}), {r['kernels']} kernels and "
                 f"{r['kernel_ms']:.3f} ms of kernel time a replay, busy "
                 f"{r['busy']:.2f}" + "".join(
                     f"; {n} {c:g} launches, {ms:.4f} ms"
                     for n, (c, ms) in r["by_kernel"].items())),
              flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
