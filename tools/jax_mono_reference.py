#!/usr/bin/env python3
"""The JAX package's runs of chip_smoke.py's `mono` and `cv2rank` paths, on
the CPU, written to tools/jax_mono_reference.npz.

    JAX_PLATFORMS=cpu python3 tools/jax_mono_reference.py

Renders chip_smoke.py's 64-frame bench corridor at KITTI size (1242x376),
then:

- `mono`: ``openvo_tpu.models.mono_odometer.MonoOdometer(K)`` on the left
  images, ``trans_scale`` the ground-truth step. Before each update it
  takes the uniforms that the frame's ``jax.random.choice`` draws from the
  odometer's key chain (``split`` of the state's key, then ``uniform`` of
  the subkey at (iters, 5)), so the port can replay JAX's draws. Saved:
  ``mono_u`` (N, iters, 5) float32, ``mono_accept`` (N,), ``mono_code``
  (N,) int32 skip codes, ``mono_stats`` (N, 4) int32 (keypoints, matches,
  inliers, support), ``mono_c_T_w`` (N, 4, 4) float32 and ``mono_ate_m``.
- `cv2rank`: ``openvo_tpu.StereoOdometer`` with chip_smoke.py's SGBM
  parameters and ``ORBParams(cv2_ranking=True)``. Saved: ``cv2rank_ok``,
  ``cv2rank_causes``, ``cv2rank_poses`` (N, 4, 4) float64,
  ``cv2rank_ate_m``.

The card that runs chip_smoke.py has no JAX, so the smoke reads these
values from the npz (about 80 KB). ~25 min and under 2 GB on one CPU core.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

OUT = os.path.join(ROOT, "tools", "jax_mono_reference.npz")


def ate(poses, gt):
    return float(np.mean(np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3],
                                        axis=1)))


def run_mono(seq, n):
    import jax
    import jax.numpy as jnp

    from openvo_tpu.models.mono_odometer import MonoOdometer

    odo = MonoOdometer(seq["K"])
    iters = chip_smoke.MONO_ITERS
    us, accept, codes, stats, c_T_w, poses = [], [], [], [], [], []
    t0 = time.perf_counter()
    for i in range(n):
        _, sub = jax.random.split(odo._state.key)
        us.append(np.asarray(jax.random.uniform(sub, (iters, 5),
                                                dtype=jnp.float32)))
        accept.append(bool(odo.update(seq["left"][i],
                                      trans_scale=chip_smoke.SEQ["step"])))
        s = odo.last_stats
        codes.append(int(s["skip_code"]))
        stats.append([int(s[k]) for k in ("n_kps", "n_matches", "n_inliers",
                                          "n_support")])
        c_T_w.append(np.asarray(odo._state.c_T_w))
        poses.append(odo.current_pose())
        print(f"mono frame {i}: accept {accept[-1]}, code {codes[-1]}, "
              f"stats {stats[-1]}, {time.perf_counter() - t0:.1f} s",
              flush=True)
    poses = np.stack(poses)
    return {"mono_u": np.stack(us).astype(np.float32),
            "mono_accept": np.asarray(accept),
            "mono_code": np.asarray(codes, np.int32),
            "mono_stats": np.asarray(stats, np.int32),
            "mono_c_T_w": np.stack(c_T_w).astype(np.float32),
            "mono_ate_m": np.float64(ate(poses, seq["T_wc"][:n]))}


def run_cv2rank(seq, n):
    import openvo_tpu
    from openvo_tpu.config import OdometerConfig, ORBParams

    cam = openvo_tpu.StereoCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                                  {"R": seq["R"], "T": seq["T"]},
                                  chip_smoke.SGBM, chip_smoke.IMG_SIZE)
    odo = openvo_tpu.StereoOdometer(
        cam, config=OdometerConfig(orb=ORBParams(cv2_ranking=True)))
    oks, causes, poses = [], [], []
    t0 = time.perf_counter()
    for i in range(n):
        oks.append(bool(odo.update(seq["left"][i], seq["right"][i])))
        causes.append(odo.skip_cause)
        poses.append(odo.current_pose())
        print(f"cv2rank frame {i}: ok {oks[-1]}, cause {causes[-1]!r}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    poses = np.stack(poses)
    return {"cv2rank_ok": np.asarray(oks),
            "cv2rank_causes": np.asarray(causes, dtype="<U16"),
            "cv2rank_poses": poses,
            "cv2rank_ate_m": np.float64(ate(poses, seq["T_wc"][:n]))}


def main() -> int:
    import jax

    seq = chip_smoke.render_sequence(workers=2)   # a small share of the CPU
    out = {"jax_version": np.asarray(jax.__version__),
           "backend": np.asarray(jax.default_backend())}
    n = chip_smoke.N_FRAMES
    out.update(run_mono(seq, n))
    out.update(run_cv2rank(seq, n))
    np.savez_compressed(OUT, **out)
    print(f"mono: {int(out['mono_accept'].sum())}/{n} accepted, "
          f"codes {out['mono_code'].tolist()}, ATE {out['mono_ate_m']} m; "
          f"cv2rank: {int(out['cv2rank_ok'].sum())}/{n} tracked, "
          f"causes {out['cv2rank_causes'].tolist()}, ATE "
          f"{out['cv2rank_ate_m']} m; written to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
