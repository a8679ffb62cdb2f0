#!/usr/bin/env python3
"""Time the SGBM kernels H1 (cost_hsweep), H2 (vsweep), H5 (hsweep) and H3
(hsweep_wta_lr) of several checkouts of the repository on one CUDA card, in
turns.

    python3 openvo_tpu_torch/tools/compare_sgbm_kernels.py ROOT [ROOT ...]

Each ROOT is a checkout (for instance the parent commit unpacked with ``git
archive`` beside this one, and this one). In the order given, one process
per ROOT imports that checkout's ``openvo_tpu_torch`` and ``chip_smoke``,
builds its kernels, renders frame 0 of chip_smoke's bench corridor at KITTI
size and takes the cases of those kernels in that checkout's
``chip_smoke.kernel_cases`` (H1 on the whole image and the 94-row bands,
H2's variants and carries over int16 and float32 C, H5, H3 over int16 and
float32 C). It times each call (a wrapper's allocations included) as the
lower of two rounds of 20 calls by CUDA events, then
one torch.profiler window of 10 calls of each gives the device time by CUDA
kernel name. Pass the roots as parent, change, change, parent to see the
spread. Prints one JSON line per ROOT and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import json, re, sys, time
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from openvo_tpu_torch import OdometerConfig, StereoCamera, _build
from openvo_tpu_torch.io import synthetic as syn

t0 = time.perf_counter()
_build.library()
build_s = time.perf_counter() - t0
rng = np.random.default_rng(cs.SEQ["seed"])
tex = syn.make_texture(rng)
planes = syn.corridor_planes(cs.SEQ["corridor_length"],
                             cs.SEQ["corridor_half_width"])
K, dist, R, T = syn.make_rig(cs.IMG_SIZE, cs.F, cs.B)
pose = syn.camera_trajectory(1, cs.SEQ["step"], cs.SEQ["yaw_rate"])[0]
left, right = cs.render_pair((K, pose, planes, tex, cs.IMG_SIZE, cs.B))
seq = {"left": np.clip(left, 0, 255).astype(np.uint8)[None],
       "right": np.clip(right, 0, 255).astype(np.uint8)[None]}
cam = StereoCamera(K, dist, K, dist, {"R": R, "T": T}, cs.SGBM, cs.IMG_SIZE,
                   device="cuda")
cases = {f"{c.name} [{c.variant}]": c.kern
         for c in cs.kernel_cases(torch, seq, cam, OdometerConfig())
         if c.name in ("cost_hsweep", "vsweep", "hsweep", "hsweep_wta_lr")}
ms = {k: min(cs.time_ms(torch, f, 20), cs.time_ms(torch, f, 20))
      for k, f in cases.items()}
by_kernel = {}
for k, f in cases.items():
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            f()
        torch.cuda.synchronize()
    # "void (anonymous namespace)::bt_box_kernel<true>(float const*, ..."
    by_kernel[k] = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            m = re.search(r"\w+_kernel", e.key)
            name = m.group(0) if m else e.key[:60]
            by_kernel[k][name] = (by_kernel[k].get(name, 0.0)
                                  + e.device_time_total / 10 / 1e3)
print(json.dumps({"build_s": build_s, "ms": ms,
                  "profiler_ms_by_kernel": by_kernel}))
"""


def main() -> int:
    roots = sys.argv[1:]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
        out = subprocess.run([sys.executable, "-c", CHILD], cwd=root, env=env,
                             capture_output=True, text=True, timeout=600)
        if out.returncode:
            print(out.stdout, out.stderr[-4000:], file=sys.stderr)
            return 1
        line = out.stdout.strip().splitlines()[-1]
        print(json.dumps({"root": root, **json.loads(line)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
