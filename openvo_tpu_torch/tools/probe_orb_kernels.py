#!/usr/bin/env python3
"""Time variants of ORB's kernels H6 (``csrc/resize.cu``) and H9
(``csrc/orb_corners.cu``) on one CUDA card, at KITTI size on the bench
corridor's frames 0-15.

    python3 openvo_tpu_torch/tools/probe_orb_kernels.py

Each variant is a text patch of the kernel's source as it stands (a phase
cut short, the spans written before the tile, another tile shape or
shared-memory budget), built by nvcc into its own library under
``csrc/build/probe/`` and called through ctypes with the wrapper's tables
(rebuilt for another tile shape); "tiles only" and "spans only" pass no
spans or no tiles to the kernel as built. The variants that compute every
output are checked bit-equal to the kernel as built. Inputs are those of
chip_smoke.py's batched cases: the corridor's frames 0-15 through the
off-lat camera, their disparity masks and the pyramid. Each variant is
timed by CUDA events on frame 0 (50 calls) and on the 16 frames as one
batch (10 calls), in two rounds, the second in reverse order; the lower
round is kept, a frame. Prints the card's name and power limit, one line a
variant and, last, a JSON object of the times.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from openvo_tpu_torch import _build  # noqa: E402
from openvo_tpu_torch.ops import orb, orb_cuda  # noqa: E402
from openvo_tpu_torch.ops.image import resize_taps  # noqa: E402

CSRC = os.path.join(ROOT, "openvo_tpu_torch", "csrc")
OUT = os.path.join(CSRC, "build", "probe")


def stop_before(marker):
    """End a tile after the phases before ``marker`` (timing only)."""
    return [(marker, "  return;\n" + marker)]


H9_TILE = """  if (b < ntiles)
    corner_block(s, stack, H, W, nl, tiles + (size_t)b * kTileInts, f, mask,
                 rows, cols, threshold, key, fkey);
"""
H9_SPANS = """  // then this block's spans outside every level's border box: -inf, a
  // warp each
  const int item = b + blocks * (threadIdx.x / kLanes);
  if (item < nspans) {
    const int* sp = spans + (size_t)item * kSpanInts;
    write_span(sp, key + f * frame,
               fkey == nullptr ? nullptr : fkey + f * frame, nullptr, W,
               -INFINITY, threadIdx.x % kLanes, kLanes);
  }
"""
H9_SHAPE = "constexpr int kTileH = 32, kTileW = 64;"
# H9's mask test inside the NMS pass, each warp's pass waiting on its reads
H9_MASK_IN_NMS = [
    ("""      if (!corner) {
        kout[(size_t)y * W + x] = neg_inf;""",
     """      if (corner && m0 != nullptr) {
        const int yi = rows[y], xi = cols[x];
        corner = yi >= 0 && xi >= 0 && m0[(size_t)yi * W + xi] != 0;
      }
      if (!corner) {
        kout[(size_t)y * W + x] = neg_inf;"""),
    ("  if (m0 != nullptr) {\n    for (int k = t; k < nc; k += kThreads) {",
     "  if (false) {\n    for (int k = t; k < nc; k += kThreads) {")]
H9 = {   # name: (patches, table settings: CORNER_TILE, SPAN_FLOATS, fkey)
    "as built": ([], None),
    "as built, with fkey": ([], {"fkey": True}),
    "with fkey, filled in a second loop": ([("""    write_span(sp, key + f * frame,
               fkey == nullptr ? nullptr : fkey + f * frame, nullptr, W,
               -INFINITY, threadIdx.x % kLanes, kLanes);""", """    write_span(sp, key + f * frame, nullptr, nullptr, W, -INFINITY,
               threadIdx.x % kLanes, kLanes);
    if (fkey != nullptr)
      write_span(sp, fkey + f * frame, nullptr, nullptr, W, -INFINITY,
                 threadIdx.x % kLanes, kLanes);""")], {"fkey": True}),
    "spans of 512 floats": ([], {"SPAN_FLOATS": 512}),
    "spans of 8192 floats": ([], {"SPAN_FLOATS": 8192}),
    "after load": (stop_before("  // 2. the pretest"), None),
    "after pretest": (stop_before("  // 3. the arc scores"), None),
    "after arcs": (stop_before("  // 4. the NMS"), None),
    "after NMS": (stop_before("  // 5. the mask test"), None),
    "after mask test": (stop_before("  // 6. Harris"), None),
    "spans first": ([(H9_TILE + H9_SPANS, H9_SPANS + H9_TILE)], None),
    "edge reads everywhere": (
        [("if (y0 < kHalo || x0 < kHalo", "if (true || y0 < kHalo")], None),
    "mask test in the NMS pass": (H9_MASK_IN_NMS, None),
    "tiles 32x32": ([(H9_SHAPE, H9_SHAPE.replace("64", "32"))],
                    {"CORNER_TILE": (32, 32)}),
    "tiles 16x64": ([(H9_SHAPE, H9_SHAPE.replace("32", "16"))],
                    {"CORNER_TILE": (16, 64)}),
    "tiles 32x96": ([(H9_SHAPE, H9_SHAPE.replace("64", "96"))],
                    {"CORNER_TILE": (32, 96)}),
}
H6_TILE = """  if (b < ntiles) {
    const int* tl = tiles + (size_t)b * kTileInts;
    resize_tile(s, img + f * plane, W, tl, r0, rn, rw, c0, cn, cw, taps,
                stack + f * frame + tl[0] * plane);
  }
"""
H6_SPANS = """  // then this block's spans: level 0 and the zeros beyond each level, a
  // warp each
  const int item = b + blocks * (threadIdx.x / kLanes);
  if (item < nspans)
    write_span(spans + (size_t)item * kSpanInts, stack + f * frame, nullptr,
               img + f * plane, W, 0.f, threadIdx.x % kLanes, kLanes);
"""
H6_BUDGET = "constexpr int kInFloats = 4096, kMidFloats = 2048;"
H6 = {   # name: (patches, table settings: RESIZE_IN, RESIZE_MID, SPAN_FLOATS)
    "as built": ([], None),
    "spans of 512 floats": ([], {"SPAN_FLOATS": 512}),
    "spans of 8192 floats": ([], {"SPAN_FLOATS": 8192}),
    "after load": (stop_before("  // 2. mid over"), None),
    "after mid": (stop_before("  // 3. the column"), None),
    "spans first": ([(H6_TILE + H6_SPANS, H6_SPANS + H6_TILE)], None),
    "24 KB image, 16 KB mid, 4 blocks an SM": (
        [(H6_BUDGET, "constexpr int kInFloats = 6144, kMidFloats = 4096;"),
         ("__launch_bounds__(kThreads, kBlocksPerSM)",
          "__launch_bounds__(kThreads)")],
        {"RESIZE_IN": 6144, "RESIZE_MID": 4096}),
}


def build(kind, name, patches):
    """Start nvcc on ``kind``.cu with ``patches``; (library, process)."""
    src = open(os.path.join(CSRC, f"{kind}.cu")).read()
    hdr = open(os.path.join(CSRC, "spans.cuh")).read()
    for old, new in patches:
        if old not in src:
            raise ValueError(f"{kind} [{name}]: the source lacks {old!r}")
        src = src.replace(old, new)
    d = os.path.join(OUT, f"{kind}-{len(os.listdir(OUT))}")
    os.makedirs(d)
    open(os.path.join(d, "k.cu"), "w").write(src)
    open(os.path.join(d, "spans.cuh"), "w").write(hdr)
    so = os.path.join(d, "k.so")
    cmd = [_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-Xcompiler",
           "-fPIC", "-shared", "-o", so, os.path.join(d, "k.cu")]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def load(so, proc, entry):
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{log[-3000:]}")
    fn = getattr(ctypes.CDLL(so), entry)
    fn.argtypes = list(_build.SIGNATURES[entry])
    fn.restype = ctypes.c_int
    return fn


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


def inputs():
    """The corridor's frames 0-15 as chip_smoke.py's batched cases take
    them: images, disparity masks, pyramid."""
    import chip_smoke
    from openvo_tpu_torch import OdometerConfig

    seq = chip_smoke.get_sequence()
    cam = chip_smoke.path_camera(seq)
    cfg = OdometerConfig()
    _, disp, img = cam.compute_3d_fn(False, False)(
        torch.as_tensor(seq["left"][:16], device="cuda"),
        torch.as_tensor(seq["right"][:16], device="cuda"))
    masks = ((disp >= cfg.min_valid_disparity)
             & (disp <= cfg.max_valid_disparity)).contiguous()
    imgs = img.to(torch.float32).contiguous()
    dims = tuple(orb._level_dims(*imgs.shape[-2:], cfg.orb))
    return imgs, masks, orb_cuda.resize_levels(imgs, dims), dims, cfg.orb


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    builds = {("H9", n): build("orb_corners", n, patches)
              for n, (patches, _) in H9.items()}
    builds.update({("H6", n): build("resize", n, patches)
                   for n, (patches, _) in H6.items()})
    imgs, masks, stack, dims, p = inputs()
    H, W = imgs.shape[-2:]
    edge, thr = p.edge_threshold, float(p.fast_threshold)
    dev = stack.device
    stream = torch.cuda.current_stream().cuda_stream
    rows, cols = (torch.as_tensor(
        orb.mask_level_table(n, tuple(d[i] for d in dims)),
        dtype=torch.int32, device=dev) for i, n in ((0, H), (1, W)))
    taps_r = [resize_taps(H, h) for h, _ in dims[1:]]
    taps_c = [resize_taps(W, w) for _, w in dims[1:]]

    def tables(settings, make):
        """``make()`` with orb_cuda's table constants set as ``settings``
        says (the rest of ``settings`` returned)."""
        settings = dict(settings or {})
        saved = {k: getattr(orb_cuda, k) for k in list(settings)
                 if hasattr(orb_cuda, k)}
        for k in saved:
            setattr(orb_cuda, k, settings.pop(k))
        try:
            return make(), settings
        finally:
            for k, v in saved.items():
                setattr(orb_cuda, k, v)

    def h9(fn, settings, frames, tiles_on=True, spans_on=True):
        (tiles, spans), rest = tables(settings, lambda: (
            orb_cuda.corner_tables.__wrapped__(H, W, dims, edge, dev)))
        st, m = stack[:frames].contiguous(), masks[:frames].contiguous()
        key = torch.empty_like(st)
        fkey = torch.empty_like(st) if rest.get("fkey") else None

        def run():
            err = fn(st.data_ptr(), H, W, len(dims), tiles.data_ptr(),
                     tiles.shape[0] * tiles_on, spans.data_ptr(),
                     spans.shape[0] * spans_on, m.data_ptr(),
                     rows.data_ptr(), cols.data_ptr(), thr, key.data_ptr(),
                     None if fkey is None else fkey.data_ptr(), frames,
                     stream)
            _build.check_launch(err, "corner_keys variant")
            return key
        return run

    def h6(fn, settings, frames, tiles_on=True, spans_on=True):
        (r0, rn, rw), (c0, cn, cw), taps, _, _ = orb_cuda.level_tables(
            H, W, dims, dev)
        (tiles, spans), _ = tables(settings, lambda: tuple(
            torch.as_tensor(a, device=dev) for a in (
                orb_cuda._resize_tiles(H, W, dims, taps_r, taps_c),
                orb_cuda.canvas_spans(H, W, [(0, 0, 0, 0)] + [
                    (0, min(h, H), 0, min(w, W)) for h, w in dims[1:]],
                    copy=(0,)))))
        im = imgs[:frames].contiguous()
        out = torch.empty((frames, len(dims), H, W), device=dev)

        def run():
            err = fn(im.data_ptr(), H, W, len(dims), tiles.data_ptr(),
                     tiles.shape[0] * tiles_on, spans.data_ptr(),
                     spans.shape[0] * spans_on, r0.data_ptr(), rn.data_ptr(),
                     rw.data_ptr(), c0.data_ptr(), cn.data_ptr(),
                     cw.data_ptr(), taps, out.data_ptr(), frames, stream)
            _build.check_launch(err, "resize_levels variant")
            return out
        return run

    runs = {}
    for (kernel, name), (so, proc) in builds.items():
        table, make = ((H9, h9) if kernel == "H9" else (H6, h6))
        fn = load(so, proc, "ovo_corner_keys" if kernel == "H9"
                  else "ovo_resize_levels")
        for frames in (1, 16):
            runs[(kernel, name, frames)] = make(fn, table[name][1], frames)
            if name == "as built":
                runs[(kernel, "tiles only", frames)] = make(
                    fn, None, frames, spans_on=False)
                runs[(kernel, "spans only", frames)] = make(
                    fn, None, frames, tiles_on=False)
    for frames in (1, 16):   # a PyTorch fill of a stack, for scale
        runs[("fill", "torch.Tensor.fill_", frames)] = (
            lambda t=torch.empty_like(stack[:frames]): t.fill_(0.0))
    want = {"H9": orb_cuda.corner_keys(stack, masks, dims, edge, thr)[0],
            "H6": orb_cuda.resize_levels(imgs, dims)}
    for (kernel, name, frames), run in runs.items():
        if frames == 16 and kernel != "fill" and not name.startswith((
                "after", "tiles only", "spans only")):
            if not torch.equal(run().view(torch.int32),
                               want[kernel].view(torch.int32)):
                raise AssertionError(f"{kernel} [{name}] differs from the "
                                     f"kernel as built")
    times = {k: [] for k in runs}
    order = list(runs)
    for rnd in range(2):
        for k in (order if rnd == 0 else order[::-1]):
            times[k].append(t_ms(runs[k], 50 if k[2] == 1 else 10) / k[2])
    out = {}
    for (kernel, name, frames), v in times.items():
        print(f"[probe] {kernel} {name}, {frames} frame(s): {min(v):.4f} ms "
              f"a frame (rounds {v[0]:.4f}, {v[1]:.4f})", flush=True)
        out.setdefault(kernel, {}).setdefault(name, {})[frames] = min(v)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
