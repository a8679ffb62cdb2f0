#!/usr/bin/env python3
"""The JAX package's odometer on chip_smoke.py's `filters` path, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_filters_reference.py [--frames N]

Renders chip_smoke.py's 64-frame bench corridor at KITTI size (1242x376),
runs ``openvo_tpu.StereoOdometer(cam, rigidity_threshold=...,
outlier_threshold=...)`` with chip_smoke.py's SGBM parameters and
thresholds (``FILTERS``) over it, and prints the frames tracked, each
frame's skip cause and the ATE against the rendered trajectory. These are
the reference values that chip_smoke.py's `filters` path holds the port to
(``FILTERS_JAX``); the port's card has no JAX, so they are written there as
constants.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=chip_smoke.N_FRAMES)
    args = ap.parse_args()
    import jax

    import openvo_tpu

    seq = chip_smoke.render_sequence(workers=2)   # a small share of the CPU
    cam = openvo_tpu.StereoCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                                  {"R": seq["R"], "T": seq["T"]},
                                  chip_smoke.SGBM, chip_smoke.IMG_SIZE)
    odo = openvo_tpu.StereoOdometer(cam, **chip_smoke.FILTERS)
    oks, causes, poses = [], [], []
    t0 = time.perf_counter()
    for i in range(args.frames):
        oks.append(bool(odo.update(seq["left"][i], seq["right"][i])))
        causes.append(odo.skip_cause)
        poses.append(odo.current_pose())
        print(f"frame {i}: ok {oks[-1]}, cause {causes[-1]!r}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    gt = np.asarray(seq["T_wc"], np.float64)[:args.frames]
    poses = np.stack(poses)
    ate = float(np.mean(np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3],
                                       axis=1)))
    print(json.dumps({"jax": jax.__version__, "backend": jax.default_backend(),
                      "config": chip_smoke.FILTERS, "frames": args.frames,
                      "tracked": sum(oks), "causes": causes,
                      "finite": bool(np.isfinite(poses).all()), "ate_m": ate}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
