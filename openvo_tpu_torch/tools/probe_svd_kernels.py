#!/usr/bin/env python3
"""Time the pose fits' kernels, H10 ``kabsch_fit`` and H11 ``jacobi_svd``
(``csrc/jacobi.cu``), on one CUDA card, this checkout's beside another's
(the parent commit's, unpacked by ``git archive``):

    python3 -m openvo_tpu_torch.tools.probe_svd_kernels [--parent DIR]

Each source is built by nvcc into its own library under
``csrc/build/probe-svd/`` and called through ctypes: this checkout's
``jacobi.cu`` as it stands; ``tools/probe_svd_onethread.cu``, H11 one
thread a matrix with the shapes fixed at compile time (registers) in the
cyclic order, for timing only; and the parent's ``jacobi.cu`` (H11 one
thread a matrix in local memory, cyclic; its H10 ``ovo_rotation_3x3``, the
3x3 SVD alone, on the same fits' cross-covariances). Inputs are
chip_smoke.py's: what a mono frame gives H11 (the five-point rows (64, 5,
9), the top 8 candidates (8, 3, 3), the refit's 9x9 Gram, one 3x3) and the
`filters` path's clouds for H10 (a frame's two attempts, 16 clouds as one
batch). This checkout's kernels are checked bit-equal to their plain
versions first, the variants' singular values against them.

Times: CUDA events around the C entry (50 calls) in two rounds, parent,
change, change, parent and the second round reversed, the lower kept;
then each call's device time from torch.profiler (20 calls), beside
``torch.linalg.svd`` of the same batch. Prints the card's name and power
limit, one line a measurement and, last, a JSON object of the times (ms).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from openvo_tpu_torch import _build  # noqa: E402
from openvo_tpu_torch.pose import kabsch  # noqa: E402

OUT = os.path.join(ROOT, "openvo_tpu_torch", "csrc", "build", "probe-svd")
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
SVD_ARGS = [_P] * 5 + [_I, _I, _I, _D, _I, _P]
# version -> (source, {entry: argument types})
SOURCES = {
    "change": ("openvo_tpu_torch/csrc/jacobi.cu",
               {"ovo_jacobi_svd": SVD_ARGS,
                "ovo_kabsch_fit": [_P] * 4 + [_I, _I, _P]}),
    "one thread, registers, cyclic": (
        "openvo_tpu_torch/tools/probe_svd_onethread.cu",
        {"ovo_jacobi_svd_onethread": SVD_ARGS}),
    "parent": ("openvo_tpu_torch/csrc/jacobi.cu",
               {"ovo_jacobi_svd": SVD_ARGS,
                "ovo_rotation_3x3": [_P] * 3 + [_I, _P]}),
}


def build(root, version):
    """Start nvcc on ``version``'s source under ``root``: (so, process)."""
    src = os.path.join(root, SOURCES[version][0])
    d = os.path.join(OUT, str(len(os.listdir(OUT))))
    os.makedirs(d)
    so = os.path.join(d, "k.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, src]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def load(version, so, proc):
    """The library's entries, typed; prints ptxas' registers and spills."""
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {version}:\n{log[-3000:]}")
    for line in log.splitlines():
        if re.search(r"Used \d+ registers|spill", line):
            print(f"[build] {version}: {line.strip()}", flush=True)
    lib = ctypes.CDLL(so)
    fns = {}
    for entry, args in SOURCES[version][1].items():
        fn = getattr(lib, entry)
        fn.argtypes = args
        fn.restype = ctypes.c_int
        fns[entry] = fn
    return lib, fns


def t_ms(fn, reps=50):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps=20):
    """(device ms a call, CUDA kernels a call) from torch.profiler; (None,
    0) when it records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, kernels = 0.0, 0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith(("Memcpy", "Memset"))):
            us += e.device_time_total
            kernels += 1
    return (us / 1e3 / reps if us else None), kernels / reps


def svd_run(fn, a):
    """A call of an ``ovo_jacobi_svd``-shaped entry on ``a``, outputs
    allocated once."""
    B, m, n = a.shape
    S = torch.empty((B, n), dtype=torch.float64, device=a.device)
    V = torch.empty((B, n, n), dtype=torch.float64, device=a.device)
    U = torch.empty((B, 3, 3) if m == n == 3 else (B, 0, 0),
                    dtype=torch.float64, device=a.device)
    sw = torch.empty((B,), dtype=torch.int32, device=a.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        _build.check_launch(fn(a.data_ptr(), S.data_ptr(), V.data_ptr(),
                               U.data_ptr() if U.numel() else None,
                               sw.data_ptr(), B, m, n, kabsch.JACOBI_TOL,
                               kabsch.JACOBI_MAX_SWEEPS, stream), "svd")
        return S, V, U, sw
    return run


def fit_run(fn, src, dst, mask):
    B, N, _ = src.shape
    T = torch.empty((B, 4, 4), dtype=torch.float32, device=src.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        _build.check_launch(fn(src.data_ptr(), dst.data_ptr(),
                               mask.data_ptr(), T.data_ptr(), B, N, stream),
                            "kabsch_fit")
        return (T,)
    return run


def rotation_run(fn, H):
    B = H.shape[0]
    V, Ut = torch.empty_like(H), torch.empty_like(H)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        _build.check_launch(fn(H.data_ptr(), V.data_ptr(), Ut.data_ptr(), B,
                               stream), "rotation_3x3")
        return V, Ut
    return run


def inputs():
    """(svd cases, fit cases) on the card, as chip_smoke.py's phase 2
    makes them."""
    import chip_smoke
    from openvo_tpu_torch import OdometerConfig

    seq = chip_smoke.get_sequence()
    cam = chip_smoke.path_camera(seq)
    five, top8, gram, one = chip_smoke.mono_svd_inputs(torch, seq)[:4]
    svd = {"(64, 5, 9) five-point rows": five, "(8, 3, 3) top 8": top8,
           "(1, 9, 9) refit's Gram": gram, "(1, 3, 3) one 3x3": one}
    cfg = dataclasses.replace(OdometerConfig(), **chip_smoke.FILTERS)
    fit = {"a frame's two fits": chip_smoke.real_clouds(
        torch, seq, cam, cfg, [(0, 1), (0, 2)]),
        f"{chip_smoke.BATCH} fits": chip_smoke.real_clouds(
        torch, seq, cam, cfg, [(i, i + 1) for i in range(chip_smoke.BATCH)])}
    svd = {k: v.to("cuda").contiguous() for k, v in svd.items()}
    fit = {k: tuple(x.to("cuda").contiguous() for x in v)
           for k, v in fit.items()}
    return svd, fit


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of the commit to compare "
                    "with (its csrc/jacobi.cu)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    roots = {"change": ROOT, "one thread, registers, cyclic": ROOT}
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
    procs = {v: build(r, v) for v, r in roots.items()}
    libs = {v: load(v, *procs[v]) for v in roots}
    svd, fit = inputs()
    runs = {}   # (kernel, version, case) -> run
    for case, a in svd.items():
        want = kabsch.jacobi_svd_plain(a)
        for version, (_, fns) in libs.items():
            entry = ("ovo_jacobi_svd_onethread" if version.startswith("one")
                     else "ovo_jacobi_svd")
            run = svd_run(fns[entry], a)
            S, V, _, _ = run()
            if version == "change":
                if not all(torch.equal(x, y) for x, y in zip(run(), want)):
                    raise AssertionError(f"H11 [{case}] differs from the "
                                         f"plain version")
            elif not torch.allclose(S, want[0], rtol=1e-12, atol=1e-12):
                raise AssertionError(f"H11 {version} [{case}]: singular "
                                     f"values off")
            runs[("H11", version, case)] = run
        runs[("H11", "torch.linalg.svd", case)] = (
            lambda a=a: torch.linalg.svd(a))
    for case, (src, dst, mask) in fit.items():
        run = fit_run(libs["change"][1]["ovo_kabsch_fit"], src, dst, mask)
        if not torch.equal(run()[0].nan_to_num(7.0), kabsch.kabsch_fit_plain(
                src, dst, mask).nan_to_num(7.0)):
            raise AssertionError(f"H10 [{case}] differs from the plain "
                                 f"version")
        runs[("H10", "change", case)] = run
        if "parent" in libs:
            H, _, _, _ = kabsch.cross_covariance(src, dst, mask)
            H = torch.where(torch.isfinite(H).all(-1).all(-1)[:, None, None],
                            H, 0.0).contiguous()
            runs[("H10", "parent", case)] = rotation_run(
                libs["parent"][1]["ovo_rotation_3x3"], H)
    rank = {"parent": 0, "change": 1}
    order = sorted(runs, key=lambda k: rank.get(k[1], 2))
    times = defaultdict(list)
    for rnd in range(2):
        for k in (order if rnd == 0 else order[::-1]):
            times[k].append(t_ms(runs[k]))
    result = {}
    for k in order:
        kernel, version, case = k
        dev, kernels = device_ms(runs[k])
        v = times[k]
        print(f"[probe] {kernel} {version} [{case}]: {min(v):.4f} ms by "
              f"events (rounds {v[0]:.4f}, {v[1]:.4f}); device "
              + ("not measured" if dev is None else f"{dev:.4f} ms")
              + f" in {kernels:g} kernels", flush=True)
        result.setdefault(kernel, {}).setdefault(version, {})[case] = {
            "events_ms": min(v), "device_ms": dev, "kernels": kernels}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
