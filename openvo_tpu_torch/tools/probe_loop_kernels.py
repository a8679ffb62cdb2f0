#!/usr/bin/env python3
"""Time the two loop kernels, H7 ``speckle_keep`` (``csrc/speckle.cu``) and
H8 ``greedy_clique`` (``csrc/clique.cu``), phase by phase on one CUDA card,
this checkout's beside another's (the parent commit's, unpacked by
``git archive``):

    python3 -m openvo_tpu_torch.tools.probe_loop_kernels [--parent DIR
        [--parent-only]]

Each kernel source is built by nvcc into its own library under
``csrc/build/probe-loop/``, as it stands and as text patches of it (other
tile shapes or pack widths; a launch or a phase cut short, for timing
only), and called through ctypes; the checkout's wrapper (``ops/
speckle_cuda.py``, ``ops/clique_cuda.py``) is timed over each library
too. Inputs are chip_smoke.py's: for H7 on-lat's disparity before the
speckle filter on the corridor's frame 0 and on frames 0-15 as one batch,
the 1 px spiral and random islands at KITTI size; for H8 the `filters`
path's two clouds (frames 1 and 2 against frame 0), 16 clouds of
consecutive frames as one batch, and the random clouds with 40 NaN rows or
30 exact ties (327-379 picks). Every variant that computes the whole
output is checked bit-equal to the plain version first.

Times: CUDA events around the C entry (50 calls, a batch 10) and around
the wrapper, in two rounds, the second in reverse order, the lower kept;
then each CUDA kernel's device time from torch.profiler (20 calls). Prints
the card's name and power limit, one line a measurement and, last, a JSON
object of the times (ms; a batch's a frame or a cloud).
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
from openvo_tpu_torch.ops import clique_cuda, sgbm, speckle_cuda  # noqa: E402
from openvo_tpu_torch.pose import rigid_clique  # noqa: E402
from openvo_tpu_torch.tools import loop_cases  # noqa: E402

OUT = os.path.join(ROOT, "openvo_tpu_torch", "csrc", "build", "probe-loop")
ENTRY = {"H7": "ovo_speckle_keep", "H8": "ovo_greedy_clique"}
SOURCE = {"H7": "speckle.cu", "H8": "clique.cu"}

# this checkout's variants: name -> (patches, whole output computed)
H7_TILE = ("constexpr int kTileH = 32;           // rows a tile",
           "constexpr int kTileWarps = 16;       // warps a tile block")


def h7_tile(rows, warps):
    return [(H7_TILE[0], H7_TILE[0].replace("32", str(rows))),
            (H7_TILE[1], H7_TILE[1].replace("16", str(warps)))]


H7_TILE_ONLY = ("  if (edges > 0)\n    border_kernel",
                "  return (int)cudaGetLastError();\n"
                "  if (edges > 0)\n    border_kernel")
H7 = {
    "as built (32x32 tiles, 16 warps)": ([], True),
    "32x32 tiles, 32 warps": (h7_tile(32, 32), True),
    "16x32 tiles, 16 warps": (h7_tile(16, 16), True),
    "64x32 tiles, 16 warps": (h7_tile(64, 16), True),
    "64x32 tiles, 32 warps": (h7_tile(64, 32), True),
    "tile launch only": ([H7_TILE_ONLY], False),
    "tile launch, run starts only": ([H7_TILE_ONLY, (
        "  // the vertical edges inside the tile",
        "  return;\n  // the vertical edges inside the tile")], False),
    "tile launch, through the unions": ([H7_TILE_ONLY, (
        "  // tile-local roots; the pixels",
        "  return;\n  // tile-local roots; the pixels")], False),
}
H8_PACK = ("constexpr int kPackWarps = 16;",
           "constexpr int kInFlight = 4; ")
H8_PACK_ONLY = ("  __syncthreads();\n  if (warp != 0) return;",
                "  __syncthreads();\n  return;")


def h8_pack(warps, in_flight):
    return [(H8_PACK[0], H8_PACK[0].replace("16", str(warps))),
            (H8_PACK[1], H8_PACK[1].replace("4", str(in_flight)))]


H8 = {
    "as built (pack by 16 warps, 4 blocks in flight)": ([], True),
    "pack only": ([H8_PACK_ONLY], False),
    "pack by 32 warps, 4 in flight": (h8_pack(32, 4), True),
    "pack by 16 warps, 1 in flight": (h8_pack(16, 1), True),
    "pack by 16 warps, 8 in flight": (h8_pack(16, 8), True),
    "pack only, 16 warps, 1 in flight": (h8_pack(16, 1) + [H8_PACK_ONLY],
                                         False),
    "pack only, 8 warps, 4 in flight": (h8_pack(8, 4) + [H8_PACK_ONLY],
                                        False),
}
# the parent's (first design's) variants
PARENT = {
    "H7": {"as built": ([], True)},
    "H8": {"as built": ([], True),
           "pack only": ([("    __syncthreads();\n  }\n  const auto con",
                           "    __syncthreads();\n  }\n  return;\n"
                           "  const auto con")], False)},
}


def build(src_dir, kernel, patches, tag):
    """Start nvcc on ``kernel``'s source in ``src_dir`` with ``patches``;
    (library path, process)."""
    src = open(os.path.join(src_dir, "openvo_tpu_torch", "csrc",
                            SOURCE[kernel])).read()
    for old, new in patches:
        if src.count(old) != 1:
            raise ValueError(f"{kernel} [{tag}]: the source holds {old!r} "
                             f"{src.count(old)} times, not once")
        src = src.replace(old, new)
    d = os.path.join(OUT, str(len(os.listdir(OUT))))
    os.makedirs(d)
    open(os.path.join(d, "k.cu"), "w").write(src)
    so = os.path.join(d, "k.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
           os.path.join(d, "k.cu")]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def load(so, proc, entry, tag):
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {tag}:\n{log[-3000:]}")
    regs = sorted(set(re.findall(r"Used \d+ registers", log)))
    lib = ctypes.CDLL(so)
    fn = getattr(lib, entry)
    fn.argtypes = list(_build.SIGNATURES[entry])
    fn.restype = ctypes.c_int
    return lib, regs


def t_ms(fn, reps):
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
    """Device ms a call by CUDA kernel (torch.profiler); {} when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = defaultdict(float)
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        m = re.search(r"(\w+_kernel)", e.key)
        if m and us:
            per[m.group(1)] += us / 1000.0 / reps
    return dict(per)


def h7_inputs():
    """name -> (disp, valid, frames) at KITTI size on the card."""
    import chip_smoke

    seq = chip_smoke.get_sequence()
    cam = chip_smoke.path_camera(seq)
    db, vb = chip_smoke.unfiltered_disparity(torch, seq, cam,
                                             chip_smoke.BATCH)
    W, H = chip_smoke.IMG_SIZE
    dev = db.device

    def card(maker, *args):
        return tuple(torch.from_numpy(x).to(dev) for x in maker(*args))

    return seq, cam, {
        "frame 0": (db[0].contiguous(), vb[0].contiguous(), 1),
        f"frames 0-{chip_smoke.BATCH - 1}": (db, vb, chip_smoke.BATCH),
        "spiral": card(loop_cases.spiral, H, W) + (1,),
        "islands": card(loop_cases.islands, 0, H, W) + (1,),
    }


def h8_inputs(seq, cam):
    """name -> (cons, num, clouds) on the card."""
    import chip_smoke
    from openvo_tpu_torch import OdometerConfig

    thr = chip_smoke.FILTERS["rigidity_threshold"]
    cfg = dataclasses.replace(OdometerConfig(), **chip_smoke.FILTERS)
    dev = cam.device
    sets = {
        "filters' two clouds": chip_smoke.real_clouds(
            torch, seq, cam, cfg, [(0, 1), (0, 2)]),
        f"{chip_smoke.BATCH} clouds": chip_smoke.real_clouds(
            torch, seq, cam, cfg, [(i, i + 1) for i in
                                   range(chip_smoke.BATCH)]),
        "40 NaN rows": tuple(torch.from_numpy(x).to(dev) for x in
                             loop_cases.clouds(1, 2, 512, 0.9, 0.2, 40)),
        "30 ties": tuple(torch.from_numpy(x).to(dev) for x in
                         loop_cases.clouds(2, 2, 512, 0.9, 0.2, 0, 30)),
    }
    out = {}
    for name, (prev, pts, mask) in sets.items():
        cons, num = rigid_clique.consistency(prev, pts, mask, thr)
        out[name] = (cons.contiguous(), num.contiguous(), cons.shape[0])
    return out


class Lib:
    """Stands in for ``_build.library()`` so the wrapper calls ``fn``."""

    def __init__(self, entry, fn):
        setattr(self, entry, fn)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of the commit to compare "
                    "with (its csrc/speckle.cu and csrc/clique.cu)")
    ap.add_argument("--parent-only", action="store_true", help="time only "
                    "the parent's kernels (before a new design first runs)")
    args = ap.parse_args()
    if args.parent_only and not args.parent:
        ap.error("--parent-only needs --parent")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    variants = {}   # (kernel, version, variant) -> (so, proc, whole)
    for kernel, table in () if args.parent_only else (("H7", H7),
                                                       ("H8", H8)):
        for name, (patches, whole) in table.items():
            variants[(kernel, "change", name)] = build(
                ROOT, kernel, patches, name) + (whole,)
    if args.parent:
        for kernel, table in PARENT.items():
            for name, (patches, whole) in table.items():
                variants[(kernel, "parent", name)] = build(
                    args.parent, kernel, patches, name) + (whole,)
    seq, cam, h7_cases = h7_inputs()
    h8_cases = h8_inputs(seq, cam)
    stream = torch.cuda.current_stream().cuda_stream
    import chip_smoke
    on_lat = chip_smoke.path_params("on-lat")
    max_diff, window = 16 * on_lat.speckle_range, on_lat.speckle_window_size

    def h7_run(fn, case):
        d, v, frames = h7_cases[case]
        H, W = d.shape[-2:]
        labels = torch.empty(d.shape, dtype=torch.int32, device=d.device)
        size, keep = torch.empty_like(labels), torch.empty_like(v)

        def run():
            _build.check_launch(fn(
                d.data_ptr(), int(d.dtype == torch.int32), v.data_ptr(),
                labels.data_ptr(), size.data_ptr(), keep.data_ptr(), frames,
                H, W, max_diff, window, stream), "speckle_keep variant")
            return labels, keep
        return run

    def h8_run(fn, case):
        cons, num, clouds = h8_cases[case]
        out = torch.empty(num.shape, dtype=torch.int32, device=num.device)

        def run():
            _build.check_launch(fn(
                cons.data_ptr(), num.data_ptr(), out.data_ptr(), clouds,
                num.shape[-1], stream), "greedy_clique variant")
            return (out,)
        return run

    def wrapped(kernel, fn, case):
        """The checkout's wrapper over ``fn``."""
        entry = ENTRY[kernel]
        if kernel == "H7":
            d, v, _ = h7_cases[case]
            call = lambda: speckle_cuda.speckle_keep(  # noqa: E731
                d, v, max_diff, window)
        else:
            cons, num, _ = h8_cases[case]
            call = lambda: (clique_cuda.greedy_clique(  # noqa: E731
                cons, num),)

        def run():
            saved = _build.library
            _build.library = lambda: Lib(entry, fn)
            try:
                return call()
            finally:
                _build.library = saved
        return run

    want = {("H7", c): sgbm.speckle_keep_plain(d, v, max_diff, window)
            for c, (d, v, _) in h7_cases.items()}
    want.update({("H8", c): (rigid_clique.greedy_clique_plain(cons, num),)
                 for c, (cons, num, _) in h8_cases.items()})
    runs, per_call = {}, {}
    libs = []
    for (kernel, version, name), (so, proc, whole) in variants.items():
        lib, regs = load(so, proc, ENTRY[kernel], f"{kernel} {version} "
                         f"[{name}]")
        libs.append(lib)
        fn = getattr(lib, ENTRY[kernel])
        print(f"[build] {kernel} {version} [{name}]: {', '.join(regs)}",
              flush=True)
        cases = h7_cases if kernel == "H7" else h8_cases
        for case, item in cases.items():
            make = h7_run if kernel == "H7" else h8_run
            key = (kernel, version, name, case)
            runs[key] = make(fn, case)
            per_call[key] = item[2]
            if whole:
                got = runs[key]()
                for _ in range(4 if kernel == "H7" else 1):
                    again = runs[key]()
                    if not all(torch.equal(a, b) for a, b in zip(
                            again, want[(kernel, case)])):
                        raise AssertionError(f"{key} differs from the plain "
                                             f"version")
                del got
            if name.startswith("as built"):
                runs[key[:2] + ("wrapper",) + key[3:]] = wrapped(kernel, fn,
                                                                 case)
                per_call[key[:2] + ("wrapper",) + key[3:]] = item[2]
    times = defaultdict(list)
    order = list(runs)
    for rnd in range(2):
        for k in (order if rnd == 0 else order[::-1]):
            reps = 50 if per_call[k] == 1 else 10
            times[k].append(t_ms(runs[k], reps) / per_call[k])
    result = {}
    for k, v in times.items():
        kernel, version, name, case = k
        print(f"[probe] {kernel} {version} [{name}] {case}: {min(v):.4f} ms "
              f"(rounds {v[0]:.4f}, {v[1]:.4f})", flush=True)
        result.setdefault(kernel, {}).setdefault(version, {}).setdefault(
            name, {})[case] = {"events_ms": min(v)}
    for k, run in runs.items():
        if k[2] == "wrapper":
            continue
        per = device_ms(run)
        kernel, version, name, case = k
        if not per:
            print(f"[device] {kernel} {version} [{name}] {case}: not "
                  f"measured (no device time in the profiler)", flush=True)
            continue
        n = per_call[k]
        split = ", ".join(f"{kn} {ms / n:.4f}" for kn, ms in per.items())
        print(f"[device] {kernel} {version} [{name}] {case}: "
              f"{sum(per.values()) / n:.4f} ms = {split}", flush=True)
        result[kernel][version][name][case]["device_ms"] = {
            kn: ms / n for kn, ms in per.items()}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
