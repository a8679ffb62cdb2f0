#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final line:

1. build the CUDA kernels (openvo_tpu_torch/csrc) with nvcc;
2. at KITTI shapes (1242x376, D=128, K=512), on frame 0 of the bench
   sequence, run each kernel and each of its variants and its plain
   PyTorch version on the card, require bit-equal outputs, and time both
   with CUDA events: the int16 path on the integer pair, the float32 path
   (blockSize 13, no int16 sentinel) on frame 0 resampled by a 0.37 px
   shift, H1 on a 94-row band with halo rows (interior, top and bottom),
   H2 with its carry handed across a split at row 188 (both ways, int16
   and float32), and the H1 -> H2 -> H3 chain at D = 48, and at D = 33 and
   1024 on 64 rows (the warp walks' lane widths at their edges); the
   redesigned H1, H2, H3 and H5 log their block walks' earlier times
   beside theirs (in the log only, not in the JSON line); H4 from frame
   0's pyramid and on a random stack with keypoints at every clamped
   edge; H9 (ORB's FAST, NMS, border and mask tests and Harris over the
   pyramid stack) on frame 0's off-lat stack with its disparity mask, as
   off-lat and as cv2rank (with the FAST-score keys) call it; then H1, H2
   (the top-down trio into s1), H3, H4 and H9 launched once over a batch
   of frames 0-15, and H5, the float32 H2 trio and H3 over
   block13's float32 C of the same frames, each also held to its 16
   single-frame launches, timed a frame; then the loops JAX runs as
   ``lax.while_loop``s: H7 (the speckle filter's labelling) on frame 0's
   on-lat disparity before the filter and on frames 0-15 as one batch, on
   a 1 px spiral, random islands, an all-invalid and a one-component map
   at KITTI size, labels and masks equal; H8 (the rigid clique's greedy
   loop) on the `filters` path's clouds of frames 1 and 2 against frame 0,
   on 16 clouds of consecutive frames as one batch, and on random clouds
   with NaN rows, exact ties and no valid row, memberships equal; the
   pose fits: H10 (the whole Kabsch fit) on the `filters` path's clouds
   (a frame's two attempts, and 16 clouds as one batch) and on degenerate
   and seeded clouds, H11 (the batched Jacobi SVD) on the inputs a mono
   frame gives it (the five-point rows, the top 8 candidates, the refit's
   9x9 Gram, one 3x3), all bit-equal, each H11 case also timed beside one
   torch.linalg.svd of the same batch; H12 (the five-point solver's root
   stage) on mono frame 1's eliminated system and null-space basis and on
   seeded five-point rows' (64 samples), bit-equal, timed by CUDA events
   and by device time beside its plain version; and
   time block13's plain float32 cost volume alone and over the batch;
3. run StereoOdometer.update over the 64-frame bench sequence (the
   corridor of bench.py, rendered here with numpy) on the card in five
   SGBM configurations, with the rigid clique and outlier filters on, and
   with ORB's cv2.ORB two-stage ranking (PATHS), with the plain versions
   disabled, and check tracking, ATE (`filters` and `cv2rank`: against
   the JAX package's runs, FILTERS_JAX and tools/jax_mono_reference.npz)
   and every kernel's launches per frame (ORB's H4, H6 and H9 once a
   frame on every path);
   then the streams (STREAMS): ``parallel/stream.make_stream_fn`` with
   chunks of 16, each extracted batched, at off-lat's SGBM (`off-tp`:
   H1-H4, H6 and H9 once a chunk), on-lat's (`on-tp`: H7 once a chunk
   too) and block13's (`block13-tp`: H5, H3 and the float32 H2's three
   launches once a chunk), and the rigs (RIGS):
   ``parallel/rig.RigOdometer`` with 8 cameras, camera 7 fed a blank pair
   at frame 20, with off-lat's settings (`rig8`) and `filters`' (`rig8-
   filters`: H8 over the 8 cameras' 16 clouds at once, and the outlier
   pass); each held to its single-frame path frame by frame (ok, skip
   cause, c_T_w within 1e-5), with launches and host syncs a frame; the
   speckle filter and the rigid clique must make no host sync on any path;
   each of these paths runs this phase eagerly (``_graph.
   disable_capture()``), its launch counts from that run, then again as
   users run it, each step one replayed CUDA graph (``openvo_tpu_torch/
   _graph.py``): ok, skip causes and c_T_w must equal the eager run's bit
   for bit, a captured frame of frames 2-63 must make exactly one host
   sync (the copy of its results; a stream call none), and the eager and
   captured medians, the warm-up plus capture seconds, the graph's pool
   and, under torch.profiler, the kernels and kernel time of a few more
   captured calls are logged; two off-lat odometers on one camera, run in
   turns, share its captured step and each equal the eager run;
4. `mono` and `mono-own`: MonoOdometer.update on the left images of the
   same 64 frames (ORB as off-lat, five-point RANSAC, recoverPose), first
   with the uniforms of JAX's draws replayed and held to JAX's run (the
   npz) frame by frame, then with the port's own sampler; each eagerly
   (H4, H6, H9 and H12 launch once a frame, H11 nine times, no SGBM
   kernel and no torch.linalg.svd), then captured, each update one
   replayed CUDA graph (H12 launched in the warm-up and at the capture
   only), equal to the eager run bit for bit with one host sync a frame
   and none from pose/;
5. `tiled4`: the row-tiled SGBM (parallel/tiling.py) on 4 ranks that share
   the card (a gloo group, messages staged through host memory: NCCL
   refuses two ranks on one GPU) over the 64 frames with the off-lat
   parameters, on frame 0 with the block13 parameters on the shifted pair
   and with on-lat's (the speckle filter over the gathered frame); the
   ranks' bands must equal the single-device disparity on the card, and
   every rank must launch the band H1 and the carry H2, and H7 on-lat;
6. `shard4`: the frame-sharded trajectory (parallel/sharding.py) on 4
   ranks sharing the card over frames 0-15, 4 a rank, against the
   one-process relative poses composed on the card; every rank launches
   each of H1-H4, H6 and H9 once;
7. the port's benchmark, ``python3 -m openvo_tpu_torch.tools.bench
   --repeats 2`` (bench.py's four passes, off-lat, off-tp, on-lat and
   rig, each in a subprocess, on the corridor cached by this run): every
   pass prints a result and ran captured, off-lat and on-lat track >= 63
   of the 64 frames
   with an ATE <= 1.25 m, off-tp and rig skip the frames off-lat skips.

Phase 2 also times K4's one-call PyTorch equivalent, ``torch.gather``
of best_r at x - best. The second-to-last lines are a JSON object with one
entry per kernel
variant on a path (and the variants checked outside any path under
"checks"), each with its time, its plain version's, and its bound (the
larger of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s),
and the card's name and power limit from nvidia-smi; the last line is
{"ok": true, "device": {...}}. Needs no network and imports no JAX.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import multiprocessing
import subprocess
import sys
import tempfile
import time

import numpy as np

from openvo_tpu_torch.tools.bench import (B, F, IMG_SIZE, N_FRAMES,  # noqa
                                          PASSES, SEQ, SGBM, SPECKLE,
                                          get_sequence, render_pair,
                                          render_sequence, sgbm_params)

# The paths of phase 3: name -> (changes to SGBM's SGBMParams, the least
# frames tracked and the largest ATE in m, None where no bar is set).
PATHS = {
    "off-lat": ({}, 63, 1.25),
    "on-lat": (SPECKLE, 63, 1.25),  # bench.py:56
    "hh8": (dict(num_paths=8), None, None),
    "hv4": (dict(num_paths=4), None, None),
    # no int16 sentinel at preFilterCap 63: the float32 path
    "block13": (dict(block_size=13, p1=8 * 169, p2=32 * 169), 62, None),
    # the odometer's rigid clique and outlier pass on (FILTERS): held to
    # FILTERS_JAX instead
    "filters": ({}, None, None),
    # ORB's cv2.ORB ranking: held to the JAX package's run instead
    "cv2rank": ({}, None, None),
}
SHARED_FRAMES = 8        # off-lat's frames run by two odometers in turns
# The `filters` path: off-lat with both of the odometer's filters on, at the
# thresholds of the JAX package's own tests (tests/test_odometer.py:228,
# :300).
FILTERS = dict(rigidity_threshold=0.05, outlier_threshold=0.01)
# The JAX package's odometer on the `filters` path, on the CPU (jax 0.9.0):
#     JAX_PLATFORMS=cpu python3 tools/jax_filters_reference.py
# The card has no JAX, so the port is held to these values: frames tracked
# within 1, the skip cause equal at every frame but at most one, ATE within
# FILTERS_ATE_TOL m, every pose finite. The port's run on an H100 matched
# every cause and the ATE to 6e-6 m; 0.01 m is room for rounding in the
# poses, not for a clique or outlier mask that keeps other points.
FILTERS_JAX = {"tracked": 62, "ate_m": 0.1577573594804592,
               "causes": [""] * 60 + ["bigdist"] * 4}   # 60, 63 not tracked
FILTERS_ATE_TOL = 0.01
FILTERS_CAUSES_DIFFERING = 1
# RANSAC hypotheses a frame of MonoOdometer's default (ransac_iters 256:
# max(256 // 4, 16) five-point samples)
MONO_ITERS = 64
# The JAX package's runs of `cv2rank` and `mono` on the CPU (jax 0.9.0),
# with the uniforms of its draws for `mono`:
#     JAX_PLATFORMS=cpu python3 tools/jax_mono_reference.py
JAX_REFERENCE = "tools/jax_mono_reference.npz"
# `cv2rank` is held as `filters` is: frames tracked within 1 of JAX's, the
# skip cause equal at every frame but at most one, ATE within 0.01 m.
CV2RANK_ATE_TOL = 0.01
CV2RANK_CAUSES_DIFFERING = 1
# `mono` replays JAX's draws, but its five-point candidates come from
# cuSOLVER's null-space basis, not LAPACK's (pose/fivepoint.py), so
# another near-tie E can win a frame's vote. The port's first run on an
# H100 accepted all 64 frames as JAX did, every skip code equal, ATE 0.104
# m against JAX's 0.110: held to the same frames accepted, the skip code
# equal at every frame but at most one, every pose finite, ATE within
# 0.02 m of JAX's (three times the gap measured). Frame by frame, each
# frame's motion against JAX's (tools/compare_mono_runs.py, run on an
# H100): a median rotation gap of 4.8e-6 rad and translation-direction gap
# of 1.8e-4 rad, the direction more than 0.1 rad off at frames 28, 48, 58
# and 61 (at 61 JAX is 1.52 rad off the ground truth, the port 1.21);
# the port with the CPU's SVD gave medians of 5.3e-5 and 1.5e-3 rad and
# 7 such frames. Held to medians within 1e-4 and 1e-3 rad and at most one
# frame more beyond 0.1 rad, so that a cheirality or recoverPose fault
# that turns a few frames fails.
# `mono-own` draws its own samples (measured: 64/64, ATE 0.122 m): every
# pose finite, at most one frame fewer accepted than JAX, ATE within 0.05
# m of JAX's.
MONO_ACCEPTED_WITHIN = 0
MONO_CODES_DIFFERING = 1
MONO_ATE_TOL = 0.02
MONO_ROT_MEDIAN = 1e-4
MONO_DIR_MEDIAN = 1e-3
MONO_DIR_OFF = 0.1
MONO_DIR_OFF_FRAMES = 5
MONO_OWN_ACCEPTED_BELOW = 1
MONO_OWN_ATE_TOL = 0.05
DEVICE = "cuda"
TILED_RANKS = 4
PROFILED = 8             # tiled frames profiled on the first and last rank
BATCH = 16               # frames a chunk on off-tp, and of phase 2's batches
RIG_CAMERAS = 8          # bench.py:47
RIG_BLANK = (7, 20)      # (camera, frame) fed a blank pair on rig8
SHARD_RANKS = 4
SHARD_FRAMES = 16        # frames 0-15 on shard4, 4 a rank
POSE_TOL = 1e-5          # c_T_w against off-lat's (tests/test_parallel.py:270)
# the paths that launch the batched kernel variants
BATCHED_PATHS = ("off-tp", "on-tp", "block13-tp", "rig8", "rig8-filters",
                 "shard4")
# the streamed paths: name -> the single-frame path of PATHS it streams and
# is held to frame by frame
STREAMS = {"off-tp": "off-lat", "on-tp": "on-lat", "block13-tp": "block13"}
# the rigs: name -> the single-frame path whose odometer settings each
# camera runs and is held to (rig8-filters: `filters`' rigid clique and
# outlier pass, the cameras' filters batched)
RIGS = {"rig8": "off-lat", "rig8-filters": "filters"}
SHIFT = 0.37             # px: frame 0 resampled so every pixel is fractional
# phase 7, the port's benchmark: its repeats, its budget (s) and the bars
# of its latency passes (PERF.md section 2)
BENCH_REPEATS = 2
BENCH_BUDGET = 480
BENCH_TRACKED = 63
BENCH_ATE = 1.25
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak rate
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
FP64_OPS_PER_S = 34e12      # H100 SXM float64 outside the tensor cores
SGBM_SRC = "openvo_tpu_torch/csrc/sgbm.cu"
WTA_SRC = "openvo_tpu_torch/csrc/sgbm_wta.cu"   # H3
ORB_SRC = "openvo_tpu_torch/csrc/orb.cu"
RESIZE_SRC = "openvo_tpu_torch/csrc/resize.cu"   # H6
SPECKLE_SRC = "openvo_tpu_torch/csrc/speckle.cu"   # H7
CLIQUE_SRC = "openvo_tpu_torch/csrc/clique.cu"     # H8
JACOBI_SRC = "openvo_tpu_torch/csrc/jacobi.cu"     # H10, H11
FIVEPOINT_SRC = "openvo_tpu_torch/csrc/fivepoint.cu"   # H12
# H12's JAX counterpart: Nister's solver after the elimination under jit,
# left to XLA (no Pallas kernel)
FIVEPOINT_JAX = ("openvo_tpu/pose/fivepoint.py:112-195 (_real_roots' "
                 "fori_loop), :217-240 (the back-substitution), XLA")
# H10's and H11's JAX counterparts: the Kabsch fit and jnp.linalg.svd under
# jit, left to XLA (no Pallas kernel)
KABSCH_JAX = ("openvo_tpu/pose/kabsch.py:22-60 (the fit; its jnp.linalg.svd "
              ":49, XLA)")
MONO_SVD_JAX = ("openvo_tpu/pose/fivepoint.py:210; openvo_tpu/pose/"
                "ransac.py:140, :142, :273 (jnp.linalg.svd, XLA)")
# H10's float64 operations on a fit's H, counted from the plain version: 5
# sweeps of 3 rotations, each the three dot products (15), the rotation's
# (c, s) (14) and the two 6-entry columns rotated (36); the norms (18), the
# shift (2), u_1 and u_2 (6), u_3 (9); R = V U^T (45) and t (18)
ROTATION_OPS = 5 * 3 * (15 + 14 + 36) + 18 + 2 + 6 + 9 + 45 + 18
# H11's SVDs a mono frame: the five-point null space, the cheirality vote
# of the top 8, two refits of (Gram, projection, vote), the final
# recoverPose
MONO_SVDS = 9
# H7's and H8's JAX counterparts: lax.while_loops left to XLA (no Pallas
# kernel)
SPECKLE_JAX = "openvo_tpu/ops/sgbm.py:476-488 (lax.while_loop, XLA)"
CLIQUE_JAX = "openvo_tpu/pose/rigid_clique.py:53-69 (lax.while_loop, XLA)"
# H6's JAX counterpart: jax.image.resize under jit, left to XLA (no Pallas
# kernel); the library call timed beside it is torch's antialiased
# bilinear F.interpolate, level by level
RESIZE_JAX = "openvo_tpu/ops/image.py:82-85 (jax.image.resize, XLA)"
# H9's JAX counterpart: ORB's per-pixel stages under jit, left to XLA (no
# Pallas kernel): fast_score (:117), _nms3x3 (:210), the border and mask
# tests, harris_response (:154)
CORNERS_JAX = "openvo_tpu/ops/orb.py:434-445 (XLA)"
CORNERS_SRC = "openvo_tpu_torch/csrc/orb_corners.cu"   # H9
# H9's float operations a pixel inside a level's border box, counted from
# the plain version: FAST 191 (32 differences, 2 x 79 for the arc folds,
# 1 max), Sobel and its products 17, the 7x7 box sums of the three
# products 36, the NMS 9, the tests 6, Harris 7
CORNER_OPS = 191 + 17 + 36 + 9 + 6 + 7
# the reach of H9's key around a pixel: FAST's circle (3) and the NMS (1),
# or Sobel (1) and the 7x7 box (3)
CORNER_HALO = 4
K5 = "openvo_tpu/ops/orb_pallas.py:60"
PALLAS_SGBM = "openvo_tpu/ops/sgbm_pallas.py"
K1 = f"{PALLAS_SGBM}:305"
K1_BAND = f"{PALLAS_SGBM}:305 (band_halo, :240-247)"
K2 = f"{PALLAS_SGBM}:478"
K2_CARRY = f"{PALLAS_SGBM}:478 (init_carry/return_carry, :478-557)"
K3_K4 = f"{PALLAS_SGBM}:1002 + {PALLAS_SGBM}:827"
K6 = f"{PALLAS_SGBM}:115"
K7_K4 = f"{PALLAS_SGBM}:716 + {PALLAS_SGBM}:827"
# The redesigned kernels' times before their redesign: the one-block-a-line
# walks on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6), by
# (kernel, variant) of kernel_cases, for the variants whose work did not
# change (H2 on the int16 paths now adds into s1 and H3 reads no sv: those
# variants have new names and their earlier times are in PERF.md). Logged
# beside this run's times only; the kernels line holds what this run
# measured.
BLOCK_WALK_MS = {
    ("cost_hsweep", "int16 C, integer pair"): 2.437,
    ("cost_hsweep", "band of 94 rows, interior, int16 C"): 1.839,
    ("cost_hsweep", "band of 94 rows, top, int16 C"): 1.833,
    ("cost_hsweep", "band of 94 rows, bottom, int16 C"): 1.812,
    ("vsweep", "down trio, int16 C (5 paths)"): 0.818,
    ("vsweep", "up trio, int16 C"): 0.820,
    ("vsweep", "vertical down, int16 C"): 0.404,
    ("vsweep", "vertical up, int16 C"): 0.398,
    ("vsweep", "down trio, float32 C (block13, shifted pair)"): 1.168,
    ("vsweep", "up trio, float32 C (shifted pair)"): 1.165,
    ("vsweep", "down trio, carry across row 188, int16 C"): 0.956,
    ("vsweep", "up trio, carry across row 188, int16 C"): 0.958,
    ("vsweep", "down trio, carry across row 188, float32 C"): 1.347,
    ("vsweep", "up trio, carry across row 188, float32 C"): 1.338,
    ("hsweep", "forward, float32 C (block13, shifted pair)"): 0.840,
    ("hsweep_wta_lr", "float32 C (block13, shifted pair)"): 1.366,
    ("hsweep_wta_lr", "float32 C with the bottom-up partial apart (8 paths)"):
        1.395,
}
# H6's, H9's, H7's and H8's times before their redesign (their first
# designs: a thread a pixel, one zeroed canvas and a copy beside it; a
# block a 32x32 tile of every level; union-find in five launches of a
# thread a pixel; one block reduction and barrier a pick), a frame or a
# cloud, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6), by
# (kernel, variant) of the kernel cases; logged beside this run's times
# only (H8's two random cases: 0.377-0.410 ms between them)
FIRST_DESIGN_MS = {
    ("resize_levels", "frame 0, 7 levels"): 0.0428,
    ("resize_levels", f"7 levels, batch of {BATCH} frames (frames "
                      f"0-{BATCH - 1})"): 0.0261,
    ("corner_keys", "frame 0's 8 levels, its disparity mask"): 0.0644,
    ("corner_keys", "frame 0's 8 levels, its disparity mask, with the "
                    "FAST-score keys (cv2.ORB's ranking)"): 0.0657,
    ("corner_keys", f"8 levels, the disparity masks, batch of {BATCH} "
                    f"frames (frames 0-{BATCH - 1})"): 0.0525,
    ("speckle_keep", "frame 0, on-lat's disparity before the filter"):
        0.0647,
    ("speckle_keep", f"frames 0-{BATCH - 1} as one batch"): 0.0191,
    ("greedy_clique", "frames 1 and 2 against frame 0, filters' threshold "
                      "(the path's two attempts)"): 0.0973,
    ("greedy_clique", f"{BATCH} clouds of consecutive frames as one batch"):
        0.0069,
    ("greedy_clique", "random clouds, 40 NaN rows"): "0.377-0.410",
    ("greedy_clique", "random clouds, 30 exact ties"): "0.377-0.410",
    # H11's first design, one thread a matrix in cyclic order (PERF.md
    # section 6)
    ("jacobi_svd", "mono frame 1: the five-point rows of 64 samples"): 0.102,
    ("jacobi_svd", "mono frame 1: the cheirality vote's top 8 candidates"):
        0.042,
    ("jacobi_svd", "mono frame 1: the refit's 9x9 Gram"): 0.231,
    ("jacobi_svd", "mono frame 1: one 3x3 (the refit's projection)"): 0.041,
}


def log(*a):
    print(*a, flush=True)


def path_params(name):
    return sgbm_params(PATHS[name][0])


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


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def max_abs_err(a, b):
    """The largest |a - b|; where either holds infinities or NaN (H9's
    keys are -inf off the corners, a degenerate Kabsch fit NaN), over the
    elements finite in both, and inf unless the others are the same values
    (NaN beside NaN) in the same places."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
                             f"{tuple(b.shape)} {b.dtype}")
    if a.is_floating_point():
        off_a, off_b = ~a.isfinite(), ~b.isfinite()
        if bool(off_a.any()) or bool(off_b.any()):
            x, y = a[off_a], b[off_b]
            if not (bool((off_a == off_b).all())
                    and bool(((x == y) | (x.isnan() & y.isnan())).all())):
                return float("inf")
            a, b = a.masked_fill(off_a, 0), b.masked_fill(off_b, 0)
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


@dataclasses.dataclass
class Case:
    """One kernel variant of phase 2. ``inputs`` are the tensors the
    function must read (once each, for its byte bound) unless ``in_bytes``
    says how much of them it must read; ``ops_per_elem`` counts its
    operations per element of its largest output."""
    name: str
    variant: str
    path: str | None
    kern: object
    plain: object
    replaces: str
    inputs: tuple
    ops_per_elem: float
    source: str = SGBM_SRC
    in_bytes: int | None = None   # bytes it must read, where not all inputs
    # a batched variant: its frames, the single-frame launches of the
    # kernel on each frame, which it must equal, and the same launches as
    # timed beside it (where ``single`` copies inputs for the check)
    frames: int = 1
    single: object = None
    single_run: object = None
    # one PyTorch call (or one a level) that computes the same function,
    # timed as library_ms; None where there is none
    library: object = None
    # what else the log line says of these inputs (H9: corners and FAST
    # pretest passes a level)
    note: str = ""
    # the operations it must do in all, where not ops_per_elem per output
    # element (H10, H11: float64, counted from the inputs' sweeps)
    ops: float | None = None
    ops_per_s: float = FP32_OPS_PER_S
    # also timed by device time under torch.profiler (H12)
    device: bool = False


def bound(case, outs):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (each input read once, each output written once) over the HBM rate and
    its operations over the float32 rate (float64's for H10 and H11)."""
    nbytes = sum(t.numel() * t.element_size() for t in outs) + (
        sum(t.numel() * t.element_size() for t in case.inputs)
        if case.in_bytes is None else case.in_bytes)
    ops = (case.ops_per_elem * max(t.numel() for t in outs)
           if case.ops is None else case.ops)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / case.ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_cases(torch, seq, cam, cfg):
    """Phase 2's cases, all at KITTI shapes on frame 0."""
    from openvo_tpu_torch.ops import orb, orb_cuda, sgbm, sgbm_cuda as sc

    dev = cam.device
    p = cam.sgbm
    cap = max(p.pre_filter_cap, 15) | 1
    lp, rp = prefiltered_pair(torch, seq, cam, 0.0, cap)
    lpf, rpf = prefiltered_pair(torch, seq, cam, SHIFT, cap)
    if torch.equal(lpf, torch.round(lpf)):
        raise AssertionError("the shifted pair is not fractional")
    p1, p2 = 2 * p.effective_p1, 2 * p.effective_p2
    sent = sgbm.int16_sentinel(p.block_size, cap)
    h1 = (p.min_disparity, p.num_disparities, p.block_size, sent, p1, p2,
          True)
    C, s1 = sc.cost_hsweep(lp, rp, *h1)
    sv = sc.vsweep(C, p1, p2, True)
    s1v = s1 + sv   # over int16 C the paths add H2's sum into s1
    wta = (p1, p2, p.min_disparity, p.uniqueness_ratio, p.disp12_max_diff)

    # the float32 path: block13 on the fractional pair
    q = path_params("block13")
    if sgbm.int16_sentinel(q.block_size, cap) is not None:
        raise AssertionError("block13 has an int16 sentinel")
    q1, q2 = q.effective_p1, q.effective_p2
    Cf = sc.cost_volume_f32(lpf, rpf, q.min_disparity, q.num_disparities,
                            q.block_size, cap, True)
    s1f = sc.hsweep(Cf, q1, q2)
    svf = sc.vsweep(Cf, q1, q2, True)
    svuf = sc.vsweep(Cf, q1, q2, True, down=False, up=True)
    wta13 = (q1, q2, q.min_disparity, q.uniqueness_ratio, q.disp12_max_diff)

    # H1 on a 94-row band (a quarter of the frame) with its 3-row halo
    h_t, halo = IMG_SIZE[1] // TILED_RANKS, p.block_size // 2 + 1

    def band_case(where, r0, path):
        rows = torch.arange(r0 - halo, r0 + h_t + halo,
                            device=dev).clamp(0, IMG_SIZE[1] - 1)
        bl, br = lp[rows].contiguous(), rp[rows].contiguous()
        band = (halo, where == "top", where == "bottom")
        return Case("cost_hsweep", f"band of {h_t} rows, {where}, int16 C",
                    path, lambda: sc.cost_hsweep(bl, br, *h1, band),
                    lambda: sc.cost_hsweep_plain(bl, br, *h1, band), K1_BAND,
                    (bl, br), 20 * p.block_size + 12)

    # H2 with the carry handed across row 188
    split = IMG_SIZE[1] // 2

    def halves(t, reverse):
        return (t[split:], t[:split]) if reverse else (t[:split], t[split:])

    def carry_case(cost, pen, reverse, path):
        """Over int16 C each half adds into its rows of s1 (a copy, which
        the timed calls keep adding into), as the row tiles do."""
        ways = dict(down=not reverse, up=reverse)
        first, second = halves(cost, reverse)
        exact = cost.dtype == torch.int16
        s1s = halves(s1, reverse) if exact else (None, None)
        accs = [t.clone() if exact else None for t in s1s]

        def run(vs):
            if vs is sc.vsweep:
                a, carry = vs(first, *pen, True, **ways, return_carry=True,
                              acc=accs[0])
                b = vs(second, *pen, True, **ways, init_carry=carry,
                       acc=accs[1])
            else:
                a, carry = vs(first, *pen, True, **ways, return_carry=True)
                b = vs(second, *pen, True, **ways, init_carry=carry)
                if exact:
                    a, b = a + s1s[0], b + s1s[1]
            return (torch.cat([b, a]) if reverse else torch.cat([a, b]),
                    carry)

        grid = "int16" if exact else "float32"
        way = "up" if reverse else "down"
        return Case("vsweep", f"{way} trio, carry across row {split}, {grid} "
                    f"C", path, lambda: run(sc.vsweep),
                    lambda: run(sc.vsweep_plain), K2_CARRY,
                    (cost, s1) if exact else (cost,), 30)

    def chain(D, rows=IMG_SIZE[1]):
        """H1 -> H2 -> H3 at D disparities on the first ``rows`` rows, as
        a Case's (kernel, plain, inputs)."""
        args = (p.min_disparity, D) + h1[2:]
        lc, rc = lp[:rows].contiguous(), rp[:rows].contiguous()

        def kern():   # as the path: H2 adds into s1, H3 reads no sv
            Cd, s1d = sc.cost_hsweep(lc, rc, *args)
            sc.vsweep(Cd, p1, p2, True, acc=s1d)
            return sc.hsweep_wta_lr(Cd, s1d, None, *wta)

        def plain():
            Cd, s1d = sc.cost_hsweep_plain(lc, rc, *args)
            return sc.hsweep_wta_lr_plain(
                Cd, s1d, sc.vsweep_plain(Cd, p1, p2, True), *wta)
        return kern, plain, (lc, rc)

    def chain_case(variant, D, rows=IMG_SIZE[1]):
        kern, plain, inputs = chain(D, rows)
        return Case("cost_hsweep+vsweep+hsweep_wta_lr", variant, None, kern,
                    plain, f"{K1}, {K2}, {K3_K4}", inputs,
                    D * (20 * p.block_size + 12 + 30 + 20))

    _, disp_f, img = cam.compute_3d_fn(False, False)(
        torch.as_tensor(seq["left"][0], device=dev),
        torch.as_tensor(seq["right"][0], device=dev))
    fmask = ((disp_f >= cfg.min_valid_disparity)
             & (disp_f <= cfg.max_valid_disparity)).to(torch.uint8)
    det = orb.detect(img, fmask, cfg.orb)
    ang = orb.orientations(det)
    h4 = (det["stack"], det["octave"], det["xy_lvl"], torch.cos(ang),
          torch.sin(ang), det["valid"])
    h4_edges = brief_edge_inputs(torch, det["stack"].shape, dev)

    def vs(variant, path, diag, down, up, cost=C, pen=(p1, p2),
           into_s1=False):
        """H2 into a zeroed sum, or into a copy of s1 as the paths over
        int16 C (the timed calls keep adding into it)."""
        ops = 10 * (3 if diag else 1) * (down + up)
        if not into_s1:
            return Case("vsweep", variant, path,
                        lambda: sc.vsweep(cost, *pen, diag, down, up),
                        lambda: sc.vsweep_plain(cost, *pen, diag, down, up),
                        K2, (cost,), ops)
        acc = s1.clone()
        return Case("vsweep", variant, path,
                    lambda: sc.vsweep(cost, *pen, diag, down, up, acc=acc),
                    lambda: s1 + sc.vsweep_plain(cost, *pen, diag, down, up),
                    K2, (cost, s1), ops)

    return [
        Case("cost_hsweep", "int16 C, integer pair", "off-lat",
             lambda: sc.cost_hsweep(lp, rp, *h1),
             lambda: sc.cost_hsweep_plain(lp, rp, *h1), K1, (lp, rp),
             20 * p.block_size + 12),
        Case("cost_hsweep", "int16 C, non-integer pair (bf16 cost)", None,
             lambda: sc.cost_hsweep(lpf, rpf, *h1),
             lambda: sc.cost_hsweep_plain(lpf, rpf, *h1), K1, (lpf, rpf),
             20 * p.block_size + 12),
        band_case("interior", h_t, "tiled4"),
        band_case("top", 0, None),
        band_case("bottom", IMG_SIZE[1] - h_t, None),
        vs("down trio into s1, int16 C (5 paths)", "off-lat", True, True,
           False, into_s1=True),
        vs("down and up trios into s1, int16 C (8 paths)", "hh8", True, True,
           True, into_s1=True),
        vs("vertical down and up into s1, int16 C (4 paths)", "hv4", False,
           True, True, into_s1=True),
        vs("down trio, int16 C (5 paths)", None, True, True, False),
        vs("up trio, int16 C", None, True, False, True),
        vs("vertical down, int16 C", None, False, True, False),
        vs("vertical up, int16 C", None, False, False, True),
        vs("down trio, float32 C (block13, shifted pair)", "block13", True,
           True, False, Cf, (q1, q2)),
        vs("up trio, float32 C (shifted pair)", None, True, False, True, Cf,
           (q1, q2)),
        carry_case(C, (p1, p2), False, "tiled4"),
        carry_case(C, (p1, p2), True, None),
        carry_case(Cf, (q1, q2), False, None),
        carry_case(Cf, (q1, q2), True, None),
        Case("hsweep", "forward, float32 C (block13, shifted pair)",
             "block13", lambda: sc.hsweep(Cf, q1, q2),
             lambda: sc.hsweep_plain(Cf, q1, q2), K6, (Cf,), 10),
        Case("hsweep_wta_lr", "int16 C, s1 holding the vertical sum",
             "off-lat",
             lambda: sc.hsweep_wta_lr(C, s1v, None, *wta),
             lambda: sc.hsweep_wta_lr_plain(C, s1v, None, *wta), K3_K4,
             (C, s1v), 20 * p.num_disparities, WTA_SRC),
        Case("hsweep_wta_lr", "float32 C (block13, shifted pair)", "block13",
             lambda: sc.hsweep_wta_lr(Cf, s1f, svf, *wta13),
             lambda: sc.hsweep_wta_lr_plain(Cf, s1f, svf, *wta13), K7_K4,
             (Cf, s1f, svf), 20 * q.num_disparities, WTA_SRC),
        Case("hsweep_wta_lr", "float32 C with the bottom-up partial apart "
             "(8 paths)", None,
             lambda: sc.hsweep_wta_lr(Cf, s1f, svf, *wta13, svuf),
             lambda: sc.hsweep_wta_lr_plain(Cf, s1f, svf, *wta13, svuf),
             K7_K4, (Cf, s1f, svf, svuf), 22 * q.num_disparities, WTA_SRC),
        chain_case("D=48: 2 disparities a lane in every walk", 48),
        chain_case("D=33 on 64 rows: D not a multiple of 8, scalar loads "
                   "at 32 disparities a lane", 33, 64),
        chain_case("D=1024 on 64 rows: 32 disparities a lane", 1024, 64),
        brief_case(torch, "K=512 on frame 0's pyramid", "off-lat", [h4]),
        resize_case(torch, "frame 0, 7 levels", "off-lat", img, cfg.orb),
        corner_case(torch, "frame 0's 8 levels, its disparity mask",
                    "off-lat", det["stack"], fmask, cfg.orb),
        corner_case(torch, "frame 0's 8 levels, its disparity mask, with "
                    "the FAST-score keys (cv2.ORB's ranking)", "cv2rank",
                    det["stack"], fmask,
                    dataclasses.replace(cfg.orb, cv2_ranking=True)),
        brief_case(torch, "random stack: window starts clamped at every "
                   "edge, levels out of range, invalid rows; K=1440, 1 and 0",
                   None, h4_edges),
    ]


def brief_edge_inputs(torch, shape, dev):
    """H4's inputs on a random non-integer stack of ``shape``: keypoints at
    and beyond every edge where the window start is clamped, on each level
    and on levels out of range, a fifth of the rows invalid, random angles;
    then the first row alone, and no row."""
    nl, H, W = shape
    rng = np.random.default_rng(7)
    stack = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32))
    edges_x = [-5, 0, 3, 21, 22, 23, W // 2, W - 24, W - 23, W - 22, W - 1,
               W + 7]
    edges_y = [-5, 0, 3, 21, 22, 23, H // 2, H - 24, H - 23, H - 22, H - 1,
               H + 7]
    lv, y, x = (a.reshape(-1) for a in np.meshgrid(
        np.arange(-1, nl + 1), edges_y, edges_x, indexing="ij"))
    ang = torch.from_numpy(rng.uniform(-np.pi, np.pi, len(lv))
                           .astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random(len(lv)) > 0.2)
    full = (stack.to(dev), torch.from_numpy(lv).to(dev),
            torch.from_numpy(np.stack([x, y], 1)).to(dev), torch.cos(ang),
            torch.sin(ang), valid.to(dev))
    return [full, (full[0], *(t[:1] for t in full[1:])),
            (full[0], *(t[:0] for t in full[1:]))]


def window_union_bytes(torch, stack, octave, xy_lvl, valid):
    """Bytes of ``stack`` under the union of the valid keypoints' 45x45 raw
    windows, their starts clamped as H4 clamps them: what H4 must read of
    the stack, each pixel once, where windows overlap."""
    from openvo_tpu_torch.ops import orb_cuda

    ids = torch.arange(stack.numel(), dtype=torch.int32,
                       device=stack.device).view(stack.shape)
    v = valid.bool()
    under = orb_cuda.patch_windows_stack(ids, octave[v], xy_lvl[v],
                                         orb_cuda.RAW_WIN)
    return int(torch.unique(under).numel()) * stack.element_size()


def brief_case(torch, variant, path, calls):
    """H4 over each of ``calls`` (argument tuples). Its byte bound counts
    the union of the valid keypoints' 45x45 raw windows (not the whole
    stack, and each pixel once where windows overlap) and the per-keypoint
    inputs; its operations are the blur's 13 a pixel over 45x39 + 39x39
    pixels and 12 a test pair, per descriptor byte."""
    from openvo_tpu_torch.ops import orb_cuda

    in_bytes = sum(window_union_bytes(torch, a[0], a[1], a[2], a[5])
                   + sum(t.numel() * t.element_size() for t in a[1:])
                   for a in calls)
    return Case("brief_describe", variant, path,
                lambda: tuple(orb_cuda.brief_describe(*a) for a in calls),
                lambda: tuple(orb_cuda.brief_describe_plain(*a)
                              for a in calls),
                K5, tuple(t for a in calls for t in a),
                ((45 * 39 + 39 * 39) * 13 + 256 * 12) / 32, ORB_SRC,
                in_bytes)


def resize_case(torch, variant, path, img, params):
    """H6 on the pyramid of ``img`` (H, W) or a batch (B, H, W), as ORB's
    detect calls it: the input read once and the (.., nl, H, W) stack
    written once; two operations (a multiply-add) for each of a level's
    output pixels' column taps times its row taps plus one."""
    import torch.nn.functional as F

    from openvo_tpu_torch.ops import orb, orb_cuda
    from openvo_tpu_torch.ops.image import resize_taps

    imgf = img.to(torch.float32).contiguous()
    H, W = imgf.shape[-2:]
    frames = imgf.shape[0] if imgf.ndim == 3 else 1
    dims = tuple(orb._level_dims(H, W, params))
    fmas = sum(int(resize_taps(W, w)[1].sum())
               * int((resize_taps(H, h)[1] + 1).sum()) for h, w in dims[1:])
    stack_elems = frames * len(dims) * H * W
    levels = imgf.reshape(-1, 1, H, W)

    def library():
        return [F.interpolate(levels, size=hw, mode="bilinear",
                              align_corners=False, antialias=True)
                for hw in dims[1:]]

    single = None
    if frames > 1:
        single = lambda: [orb_cuda.resize_levels(imgf[i], dims)  # noqa
                          for i in range(frames)]
    return Case("resize_levels", variant, path,
                lambda: orb_cuda.resize_levels(imgf, dims),
                lambda: orb_cuda.resize_levels_plain(imgf, dims), RESIZE_JAX,
                (imgf,), 2 * fmas * frames / stack_elems, RESIZE_SRC,
                frames=frames, single=single, library=library)


def present(keys):
    """The tensors of H9's (key, fkey) pair: fkey is None without cv2's
    ranking."""
    return tuple(t for t in keys if t is not None)


def corner_in_bytes(torch, stack, m0, dims, b, threshold):
    """Bytes H9's function must read of the stack (..., nl, H, W) and the
    mask m0 (..., H, W): of each level, its border box and CORNER_HALO
    pixels around it, clipped to the canvas (whose edge pads); of the mask,
    each pixel once that the mask test reads at a pixel that is a corner
    before that test (anywhere else the key is -inf whatever the mask)."""
    from openvo_tpu_torch.ops import orb

    nl, H, W = stack.shape[-3:]
    frames = stack.shape[0] if stack.ndim == 4 else 1

    def span(n_l, n):
        if min(n_l - b, n) <= b:
            return 0
        return min(n_l - b + CORNER_HALO, n) - max(b - CORNER_HALO, 0)

    read = frames * sum(span(h, H) * span(w, W) for h, w in dims)
    free, _ = orb.corner_keys_plain(stack, None, dims, b, threshold)
    f, lv, y, x = torch.isfinite(free).reshape(frames, nl, H, W).nonzero(
        as_tuple=True)
    dev = stack.device
    rows = torch.as_tensor(orb.mask_level_table(H, [h for h, _ in dims]),
                           device=dev).long()
    cols = torch.as_tensor(orb.mask_level_table(W, [w for _, w in dims]),
                           device=dev).long()
    at = (f * H + rows[lv, y]) * W + cols[lv, x]
    return (read * stack.element_size()
            + int(torch.unique(at).numel()) * m0.element_size())


def corner_case(torch, variant, path, stack, fmask, params):
    """H9 on the pyramid ``stack`` (..., nl, H, W) with the disparity mask
    ``fmask`` (..., H, W), as ORB's detect calls it (fkey too with
    ``params.cv2_ranking``): the part of the stack and the mask that the
    keys depend on read once (:func:`corner_in_bytes`) and the keys written
    once; CORNER_OPS operations a pixel inside each level's border box (a
    pixel outside it is -inf by the border test alone)."""
    from openvo_tpu_torch.ops import orb, orb_cuda

    nl, H, W = stack.shape[-3:]
    frames = stack.shape[0] if stack.ndim == 4 else 1
    dims = tuple(orb._level_dims(H, W, params))
    b = params.edge_threshold
    m0 = (fmask > 0).contiguous()
    thr = float(params.fast_threshold)
    args = (dims, b, thr, params.cv2_ranking)
    inside = sum(max(min(h - b, H) - b, 0) * max(min(w - b, W) - b, 0)
                 for h, w in dims)
    single = None
    note = ""
    if frames > 1:
        single = lambda: [present(orb_cuda.corner_keys(  # noqa
            stack[i], m0[i], *args)) for i in range(frames)]
    else:
        note = corner_counts(torch, stack, m0, dims, b, thr)
    return Case("corner_keys", variant, path,
                lambda: present(orb_cuda.corner_keys(stack, m0, *args)),
                lambda: present(orb.corner_keys_plain(stack, m0, *args)),
                CORNERS_JAX, (stack, m0), CORNER_OPS * inside / (nl * H * W),
                CORNERS_SRC, corner_in_bytes(torch, stack, m0, dims, b, thr),
                frames=frames, single=single, note=note)


def corner_counts(torch, stack, m0, dims, b, threshold):
    """What H9 computes on one frame's stack, a level: its corners (finite
    keys), and the pixels of the level inside the canvas that pass FAST's
    cardinal pretest (either polarity), where it computes FAST's arcs."""
    from openvo_tpu_torch.ops import orb, orb_cuda

    H, W = stack.shape[-2:]
    key, _ = orb.corner_keys_plain(stack, m0, dims, b, threshold)
    bright, dark = orb_cuda.fast_pretest(stack, threshold)
    corners = [int(torch.isfinite(k).sum()) for k in key]
    passes, share = [], []
    for level, (h, w) in enumerate(dims):
        hh, ww = min(h, H), min(w, W)
        n = int((bright | dark)[level, :hh, :ww].sum())
        passes.append(n)
        share.append(round(100 * n / (hh * ww), 1))
    return (f"corners a level {corners} ({sum(corners)}), FAST pretest "
            f"passes a level {passes} ({share} % of each level's pixels)")


def batched_cases(torch, seq, cam, cfg):
    """Phase 2's batched variants, as the batched paths launch them: H1, H2
    (the top-down trio into s1), H3 and H4 once over frames 0-15 (BATCH)
    at KITTI shapes (off-tp, on-tp, rig8, rig8-filters, shard4), and H5,
    the float32 H2 trio and H3 over block13's float32 C of the same frames
    (block13-tp); each against its kernel's single-frame launch on each
    frame and its plain version on the batch."""
    from openvo_tpu_torch.ops import orb, orb_cuda, sgbm, sgbm_cuda as sc

    dev = cam.device
    p = cam.sgbm
    cap = max(p.pre_filter_cap, 15) | 1
    frames = range(BATCH)
    lp, rp = (torch.stack(t) for t in zip(*(
        prefiltered_pair(torch, seq, cam, 0.0, cap, i) for i in frames)))
    p1, p2 = 2 * p.effective_p1, 2 * p.effective_p2
    h1 = (p.min_disparity, p.num_disparities, p.block_size,
          sgbm.int16_sentinel(p.block_size, cap), p1, p2, True)
    C, s1 = sc.cost_hsweep(lp, rp, *h1)
    s1v = sc.vsweep(C, p1, p2, True, acc=s1.clone())
    acc = s1.clone()
    wta = (p1, p2, p.min_disparity, p.uniqueness_ratio, p.disp12_max_diff)
    variant = f"batch of {BATCH} frames (frames 0-{BATCH - 1})"

    _, disp, img = cam.compute_3d_fn(False, False)(
        torch.as_tensor(seq["left"][:BATCH], device=dev),
        torch.as_tensor(seq["right"][:BATCH], device=dev))
    fmask = ((disp >= cfg.min_valid_disparity)
             & (disp <= cfg.max_valid_disparity)).to(torch.uint8)
    det = orb.detect(img, fmask, cfg.orb)
    ang = orb.orientations(det)
    h4 = (det["stack"], det["octave"], det["xy_lvl"], torch.cos(ang),
          torch.sin(ang), det["valid"])
    h4_bytes = sum(window_union_bytes(torch, h4[0][i], h4[1][i], h4[2][i],
                                      h4[5][i]) for i in frames) + sum(
        t.numel() * t.element_size() for t in h4[1:])

    # block13's float32 path on the same frames, as block13-tp runs it
    q = path_params("block13")
    q1, q2 = q.effective_p1, q.effective_p2
    Cf = sc.cost_volume_f32(lp, rp, q.min_disparity, q.num_disparities,
                            q.block_size, cap, True)
    s1f = sc.hsweep(Cf, q1, q2)
    svf = sc.vsweep(Cf, q1, q2, True)
    wta13 = (q1, q2, q.min_disparity, q.uniqueness_ratio, q.disp12_max_diff)

    return [
        Case("cost_hsweep", f"int16 C, {variant}", "off-tp",
             lambda: sc.cost_hsweep(lp, rp, *h1),
             lambda: sc.cost_hsweep_plain(lp, rp, *h1), K1, (lp, rp),
             20 * p.block_size + 12, frames=BATCH,
             single=lambda: [sc.cost_hsweep(lp[i], rp[i], *h1)
                             for i in frames]),
        Case("vsweep", f"down trio into s1, int16 C (5 paths), {variant}",
             "off-tp", lambda: sc.vsweep(C, p1, p2, True, acc=acc),
             lambda: s1 + sc.vsweep_plain(C, p1, p2, True), K2, (C, s1), 30,
             frames=BATCH,
             single=lambda: [sc.vsweep(C[i], p1, p2, True,
                                       acc=s1[i].clone()) for i in frames],
             single_run=lambda: [sc.vsweep(C[i], p1, p2, True, acc=acc[i])
                                 for i in frames]),
        Case("hsweep_wta_lr", f"int16 C, s1 holding the vertical sum, "
             f"{variant}", "off-tp",
             lambda: sc.hsweep_wta_lr(C, s1v, None, *wta),
             lambda: sc.hsweep_wta_lr_plain(C, s1v, None, *wta), K3_K4,
             (C, s1v), 20 * p.num_disparities, WTA_SRC, frames=BATCH,
             single=lambda: [sc.hsweep_wta_lr(C[i], s1v[i], None, *wta)
                             for i in frames]),
        Case("brief_describe", f"K=512 on each frame's pyramid, {variant}",
             "off-tp", lambda: orb_cuda.brief_describe(*h4),
             lambda: orb_cuda.brief_describe_plain(*h4), K5, h4,
             ((45 * 39 + 39 * 39) * 13 + 256 * 12) / 32, ORB_SRC, h4_bytes,
             frames=BATCH,
             single=lambda: [orb_cuda.brief_describe(*(t[i] for t in h4))
                             for i in frames]),
        resize_case(torch, f"7 levels, {variant}", "off-tp", img, cfg.orb),
        corner_case(torch, f"8 levels, the disparity masks, {variant}",
                    "off-tp", det["stack"], fmask, cfg.orb),
        Case("hsweep", f"forward, float32 C (block13), {variant}",
             "block13-tp", lambda: sc.hsweep(Cf, q1, q2),
             lambda: sc.hsweep_plain(Cf, q1, q2), K6, (Cf,), 10,
             frames=BATCH,
             single=lambda: [sc.hsweep(Cf[i], q1, q2) for i in frames]),
        Case("vsweep", f"down trio, float32 C (block13), {variant}",
             "block13-tp", lambda: sc.vsweep(Cf, q1, q2, True),
             lambda: sc.vsweep_plain(Cf, q1, q2, True), K2, (Cf,), 30,
             frames=BATCH,
             single=lambda: [sc.vsweep(Cf[i], q1, q2, True)
                             for i in frames]),
        Case("hsweep_wta_lr", f"float32 C (block13), {variant}",
             "block13-tp", lambda: sc.hsweep_wta_lr(Cf, s1f, svf, *wta13),
             lambda: sc.hsweep_wta_lr_plain(Cf, s1f, svf, *wta13), K7_K4,
             (Cf, s1f, svf), 20 * q.num_disparities, WTA_SRC, frames=BATCH,
             single=lambda: [sc.hsweep_wta_lr(Cf[i], s1f[i], svf[i], *wta13)
                             for i in frames]),
    ]


def unfiltered_disparity(torch, seq, cam, frames):
    """on-lat's disparity of the first ``frames`` frames as one batch
    before the speckle filter, and its valid mask: H7's input on on-tp
    (and, frame 0's, on on-lat: a batch gives each frame its own call's
    bits)."""
    from openvo_tpu_torch.ops import sgbm
    from openvo_tpu_torch.ops.remap import remap_bilinear

    p = path_params("on-lat")
    left, right = (torch.stack([
        remap_bilinear(torch.as_tensor(seq[side][i], device=cam.device)
                       .to(torch.float32), *maps) for i in range(frames)])
        for side, maps in (("left", cam.map_left), ("right", cam.map_right)))
    d16 = sgbm.sgbm_disparity16(
        left, right, dataclasses.replace(p, speckle_window_size=0))
    return d16, d16 != (p.min_disparity - 1) * 16


def real_clouds(torch, seq, cam, cfg, pairs):
    """The point clouds the `filters` path fits, (len(pairs), 512, 3) each
    with the match mask: frame b matched against frame a for each (a, b)
    of ``pairs``, each frame extracted on its own."""
    from openvo_tpu_torch.models.stereo_odometer import (FrameFeatures,
                                                         make_pipeline_fns)

    fns = make_pipeline_fns(cam, cfg, False)
    feats = {i: fns["extract"](torch.as_tensor(seq["left"][i],
                                               device=cam.device),
                               torch.as_tensor(seq["right"][i],
                                               device=cam.device))
             for i in sorted({i for pair in pairs for i in pair})}

    def stack(side):
        return FrameFeatures(*(torch.stack([feats[pair[side]][k]
                                            for pair in pairs])
                               for k in range(len(FrameFeatures._fields))))

    pts_a, pts_b, mok, _, _ = fns["point_clouds"](stack(0), stack(1))
    return pts_a, pts_b, mok


def loop_kernel_cases(torch, seq, cam, cfg):
    """Phase 2's cases of H7 and H8, the loops JAX runs as
    ``lax.while_loop``s, against their plain versions on the same card
    tensors (and, for the path's inputs, on the CPU): H7 on frame 0's
    on-lat disparity before the filter (on-lat) and on frames 0-15 as one
    batch (on-tp), on the CPU tests' spiral and random islands at KITTI
    size, an all-invalid and a one-component map; H8 on the `filters`
    path's clouds of frames 1 and 2 against frame 0 (its two attempts),
    on 16 clouds of consecutive frames as one batch (rig8-filters), and on
    random clouds with NaN rows, exact ties and no valid row. Each byte
    bound counts its inputs read once and its outputs written once."""
    from openvo_tpu_torch.ops import clique_cuda, sgbm, speckle_cuda
    from openvo_tpu_torch.pose import rigid_clique
    from openvo_tpu_torch.tools import loop_cases

    dev = cam.device
    p = path_params("on-lat")
    max_diff, window = 16 * p.speckle_range, p.speckle_window_size
    H, W = IMG_SIZE[1], IMG_SIZE[0]
    n = H * W

    def h7(variant, path, d, valid, frames=1):
        single = None
        if frames > 1:
            single = lambda: [  # noqa: E731
                tuple(o + i * n if o.dtype == torch.int32 else o for o in
                      speckle_cuda.speckle_keep(d[i], valid[i], max_diff,
                                                window))
                for i in range(frames)]
        return Case("speckle_keep", variant, path,
                    lambda: speckle_cuda.speckle_keep(d, valid, max_diff,
                                                      window),
                    lambda: sgbm.speckle_keep_plain(d, valid, max_diff,
                                                    window),
                    SPECKLE_JAX, (d, valid), 12, SPECKLE_SRC, frames=frames,
                    single=single)

    def on_card(maker, *args):
        return tuple(torch.from_numpy(x).to(dev) for x in maker(*args))

    db, vb = unfiltered_disparity(torch, seq, cam, BATCH)
    d0, v0 = db[0], vb[0]
    if not all(torch.equal(a.cpu(), b) for a, b in zip(
            speckle_cuda.speckle_keep(d0, v0, max_diff, window),
            sgbm.speckle_keep_plain(d0.cpu(), v0.cpu(), max_diff, window))):
        raise AssertionError("H7 on frame 0 differs from the plain version "
                             "on the CPU")
    cases = [
        h7("frame 0, on-lat's disparity before the filter", "on-lat", d0, v0),
        h7(f"frames 0-{BATCH - 1} as one batch", "on-tp", db, vb, BATCH),
        h7("a 1 px spiral at KITTI size", None,
           *on_card(loop_cases.spiral, H, W)),
        h7("random islands at KITTI size", None,
           *on_card(loop_cases.islands, 0, H, W)),
        h7("every pixel invalid", None,
           *on_card(loop_cases.uniform, H, W, False)),
        h7("one component", None, *on_card(loop_cases.uniform, H, W, True)),
    ]

    thr = FILTERS["rigidity_threshold"]

    def h8(variant, path, prev, pts, mask, frames=1):
        cons, num = rigid_clique.consistency(prev, pts, mask, thr)
        single = None
        if frames > 1:
            single = lambda: [clique_cuda.greedy_clique(  # noqa: E731
                cons[i], num[i]) for i in range(frames)]
        picks = (clique_cuda.greedy_clique(cons, num).sum(-1) - 1).tolist()
        log(f"[kernels] greedy_clique [{variant}]: picks a cloud {picks}")
        return Case("greedy_clique", variant, path,
                    lambda: clique_cuda.greedy_clique(cons, num),
                    lambda: rigid_clique.greedy_clique_plain(cons, num),
                    CLIQUE_JAX, (cons, num), 4 * prev.shape[-2], CLIQUE_SRC,
                    frames=frames, single=single)

    filters_cfg = dataclasses.replace(cfg, **FILTERS)
    two = real_clouds(torch, seq, cam, filters_cfg, [(0, 1), (0, 2)])
    want = rigid_clique.rigid_body_filter(*(t.cpu() for t in two), thr)
    if not torch.equal(rigid_clique.rigid_body_filter(*two, thr).cpu(),
                       want):
        raise AssertionError("the rigid clique on the card differs from "
                             "the CPU's on frames 1 and 2")
    sixteen = real_clouds(torch, seq, cam, filters_cfg,
                          [(i, i + 1) for i in range(BATCH)])
    cases += [
        h8("frames 1 and 2 against frame 0, filters' threshold (the "
           "path's two attempts)", "filters", *two),
        h8(f"{BATCH} clouds of consecutive frames as one batch",
           "rig8-filters", *sixteen, frames=BATCH),
        h8("random clouds, 40 NaN rows", None,
           *on_card(loop_cases.clouds, 1, 2, 512, 0.9, 0.2, 40)),
        h8("random clouds, 30 exact ties", None,
           *on_card(loop_cases.clouds, 2, 2, 512, 0.9, 0.2, 0, 30)),
        h8("no valid row", None,
           *on_card(loop_cases.clouds, 3, 2, 512, 0.0)),
    ]
    return cases


def roots_ops(samples):
    """H12's float32 operations for ``samples`` samples (a sine, cosine,
    power or tangent counted as one), from the plain version: B(z) 45; the
    minors 27 x 19 and the cofactor terms 39 x 9, n 26, its scaling 27; the
    scan 512 x 66 (sine, cosine, 26 powers, 26 products, 12 sums) and 511
    x 2 sign tests; 48 bisection steps of 10 slots x 71 (the midpoint 2, q
    66, the test 2, the update 1); then 10 slots x 200 (the tangent, 5
    powers, B(z) 81, 3 cross products 27, the pick, x and y, E 45, its
    norm 18, the division 9, validity, rounded up)."""
    per = (45 + 27 * 19 + 39 * 9 + 26 + 27 + 512 * 66 + 511 * 2
           + 48 * 10 * 71 + 10 * 200)
    return float(per * samples)


def device_ms(torch, fn, reps=20):
    """fn()'s mean device time in ms over ``reps`` calls: its CUDA kernels'
    time under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps


def svd_ops(sweeps, m, n):
    """H11's float64 operations on matrices of m x n that ran ``sweeps``
    sweeps each (its fourth output). A sweep of an m x n matrix: every
    pair's three dot products and test (6m + 4), and, in every sweep but a
    done matrix's last, its rotation ((c, s), 14, and two columns of A over
    V, 6 (m + n)); then the norms (2mn) and the sort (n^2). A wide matrix
    (m < n) first: its float32 LQ (reflector i: its norm, beta, tau
    and v, 3(n - i) + 8; each later row and each of Q's n columns, 4(n -
    i) + 1), the sweeps on the m x m L, and V's first m columns (n m (2m -
    1))."""
    from openvo_tpu_torch.pose import kabsch

    sw = sweeps.to("cpu").long()
    extra = 0
    if m < n:
        extra = sum(3 * (n - i) + 8 + (m - 1 - i + n) * (4 * (n - i) + 1)
                    for i in range(m)) + n * m * (2 * m - 1)
        n = m
    pairs = n * (n - 1) // 2
    rotating = sw - (sw < kabsch.JACOBI_MAX_SWEEPS).long()
    return float((sw * pairs * (6 * m + 4)
                  + rotating * pairs * (14 + 6 * (m + n))).sum()
                 + len(sw) * (2 * m * n + n * n + extra))


def mono_svd_inputs(torch, seq, frame=1):
    """The matrices H11 takes in mono's update of ``frame`` (JAX's draws
    replayed, after frame 0), as the card runs it eagerly: the inputs of
    ``pose/kabsch.svd``'s route to the operator, in call order, as the
    operator takes them (``kabsch.jacobi_input``)."""
    from openvo_tpu_torch import _graph
    from openvo_tpu_torch.models.mono_odometer import MonoOdometer
    from openvo_tpu_torch.pose import kabsch

    ref = jax_reference()
    odo = MonoOdometer(seq["K"], device=DEVICE)
    route, seen = kabsch._svd_jacobi, []

    def record(a):
        seen.append(kabsch.jacobi_input(a))
        return route(a)

    with _graph.disable_capture():
        for i in range(frame + 1):
            if i == frame:
                kabsch._svd_jacobi = record
            try:
                odo.update(seq["left"][i], trans_scale=SEQ["step"],
                           u=torch.from_numpy(ref["mono_u"][i]).to(DEVICE))
            finally:
                kabsch._svd_jacobi = route
    if len(seen) != MONO_SVDS:
        raise AssertionError(f"mono: {len(seen)} SVDs in a frame, expected "
                             f"{MONO_SVDS}")
    return seen


def fit_ops(mask):
    """H10's float64 operations on clouds whose valid rows the (B, N)
    ``mask`` marks, counted from the plain version over the V valid rows
    of each fit (invalid rows add nothing): the 6 masked sums (6 (V - 1)),
    the means (6), the centring (6 V), the 9 products (9 V) and their sums
    (9 (V - 1)), then ROTATION_OPS on H, where V >= 3."""
    v = mask.sum(-1).to("cpu").long()
    sums = 15 * (v - 1).clamp_min(0) + 6 + 15 * v
    return float((sums + (v >= 3).long() * ROTATION_OPS).sum())


def svd_kernel_cases(torch, seq, cam, cfg):
    """Phase 2's cases of the Kabsch fit, the small SVDs and the five-point
    solver's root stage against their plain versions: H10 on the `filters` path's clouds of frames 1 and 2
    against frame 0 (a frame's two attempts, as every single-frame stereo
    path batches them), on 16 clouds of consecutive frames as one batch (a
    rig step's), on seeded clouds of every kind and on degenerate clouds
    (``svd_cases.degenerate_clouds``); H11 on what a mono frame gives it:
    the five-point rows (64, 5, 9), the cheirality vote's 8 candidates,
    the refit's 9x9 Gram, one 3x3 matrix, and seeded 5x9 rows and
    degenerate 3x3 matrices; H12 on the eliminated systems and bases of
    mono frame 1's 64 samples (from its five-point rows, as the step makes
    them: H11's null space, the constraint rows, solve_ex) and of seeded
    rows. Each H11 case is timed beside one ``torch.linalg.svd`` of the
    same batch; no one PyTorch call computes a Kabsch fit or the root
    stage."""
    from openvo_tpu_torch.ops import fivepoint_cuda, jacobi_cuda
    from openvo_tpu_torch.pose import fivepoint, kabsch
    from openvo_tpu_torch.tools import svd_cases

    dev = cam.device

    def h10(variant, path, clouds, frames=1):
        src, dst, mask = (x.to(dev).contiguous() for x in clouds)
        single = None
        if frames > 1:
            single = lambda: [jacobi_cuda.kabsch_fit(  # noqa: E731
                src[i:i + 1], dst[i:i + 1], mask[i:i + 1])[0]
                for i in range(frames)]
        return Case("kabsch_fit", variant, path,
                    lambda: jacobi_cuda.kabsch_fit(src, dst, mask),
                    lambda: kabsch.kabsch_fit_plain(src, dst, mask),
                    KABSCH_JAX, (src, dst, mask), 0, JACOBI_SRC,
                    frames=frames, single=single, ops=fit_ops(mask),
                    ops_per_s=FP64_OPS_PER_S,
                    note=f"{tuple(src.shape)}, valid rows "
                         f"{mask.sum(-1).tolist()}")

    def h11(variant, path, a):
        a = kabsch.jacobi_input(a).to(dev).contiguous()
        m, n = a.shape[-2:]
        sweeps = jacobi_cuda.jacobi_svd(a, kabsch.JACOBI_TOL,
                                        kabsch.JACOBI_MAX_SWEEPS)[3]
        return Case("jacobi_svd", variant, path,
                    lambda: jacobi_cuda.jacobi_svd(
                        a, kabsch.JACOBI_TOL, kabsch.JACOBI_MAX_SWEEPS),
                    lambda: kabsch.jacobi_svd_plain(a), MONO_SVD_JAX, (a,),
                    0, JACOBI_SRC, library=lambda: torch.linalg.svd(a),
                    ops=svd_ops(sweeps, m, n), ops_per_s=FP64_OPS_PER_S,
                    note=f"{tuple(a.shape)}, sweeps a matrix "
                         f"{sorted(set(sweeps.tolist()))}")

    def h12(variant, path, rows):
        basis = fivepoint.basis_of_rows(rows.to(dev).float()).contiguous()
        M = fivepoint.eliminated_system(basis).contiguous()
        valid = fivepoint_cuda.five_point_roots(M, basis)[1]
        return Case("five_point_roots", variant, path,
                    lambda: fivepoint_cuda.five_point_roots(M, basis),
                    lambda: fivepoint.five_point_roots_plain(M, basis),
                    FIVEPOINT_JAX, (M, basis), 0, FIVEPOINT_SRC,
                    ops=roots_ops(len(M)), device=True,
                    note=f"{tuple(M.shape)}, valid candidates "
                         f"{int(valid.sum())} of {valid.numel()}")

    filters_cfg = dataclasses.replace(cfg, **FILTERS)
    two = real_clouds(torch, seq, cam, filters_cfg, [(0, 1), (0, 2)])
    sixteen = real_clouds(torch, seq, cam, filters_cfg,
                          [(i, i + 1) for i in range(BATCH)])
    five, top8, gram, one = mono_svd_inputs(torch, seq)[:4]
    return [
        h10("frames 1 and 2 against frame 0 (a frame's two attempts)",
            "off-lat", two),
        h10(f"{BATCH} clouds of consecutive frames as one batch", "rig8",
            sixteen, frames=BATCH),
        h10("100 seeded clouds: general, planar, 3 and 10 points, "
            "collinear", None,
            tuple(torch.from_numpy(x) for x in svd_cases.clouds(0, 100))),
        h10("degenerate clouds: 2 valid rows, NaN in a valid row, inf and "
            "NaN in invalid rows, planar, 3 points, collinear, none valid",
            None, tuple(torch.from_numpy(x)
                        for x in svd_cases.degenerate_clouds())),
        h11("mono frame 1: the five-point rows of 64 samples", "mono",
            five),
        h11("mono frame 1: the cheirality vote's top 8 candidates", None,
            top8),
        h11("mono frame 1: the refit's 9x9 Gram", None, gram),
        h11("mono frame 1: one 3x3 (the refit's projection)", None, one),
        h11("seeded five-point rows of 64 samples", None,
            torch.from_numpy(svd_cases.five_point_rows(0, 64))),
        h11("degenerate 3x3: rank 0-2, equal singular values, det -1, "
            "extreme scales", None,
            torch.from_numpy(svd_cases.degenerate_3x3())),
        h12("mono frame 1: the eliminated systems of 64 samples", "mono",
            five),
        h12("seeded five-point rows of 64 samples", None,
            torch.from_numpy(svd_cases.five_point_rows(0, 64))),
    ]


def prefiltered_pair(torch, seq, cam, shift, cap, frame=0):
    """A frame (0 unless given), rectified (and resampled by ``shift`` px),
    prefiltered."""
    from openvo_tpu_torch.ops import sgbm
    from openvo_tpu_torch.ops.remap import remap_bilinear

    return tuple(
        sgbm.prefilter_xsobel(remap_bilinear(
            torch.as_tensor(seq[side][frame], device=cam.device).to(
                torch.float32), mx + shift, my + shift), cap)
        for side, (mx, my) in (("left", cam.map_left),
                               ("right", cam.map_right)))


def check_kernels(torch, seq, cam, cfg):
    """Phase 2: each kernel variant against its plain version (a batched
    variant also against its kernel's single-frame launch on each frame;
    its times and bound are per frame)."""
    results = []
    cases = (kernel_cases(torch, seq, cam, cfg)
             + batched_cases(torch, seq, cam, cfg)
             + loop_kernel_cases(torch, seq, cam, cfg)
             + svd_kernel_cases(torch, seq, cam, cfg))
    for c in cases:
        out, h2 = h2_kernels(c.kern)
        out, ref = as_tuple(out), as_tuple(c.plain())
        err = max(max_abs_err(a, b) for a, b in zip(out, ref))
        err_single = None
        if c.single is not None:
            err_single = max(max_abs_err(a[i], b)
                             for i, one in enumerate(c.single())
                             for a, b in zip(out, as_tuple(one), strict=True))
        log(f"[kernels] {c.name} [{c.variant}]: shapes "
            f"{[tuple(o.shape) for o in out]}, max_abs_err vs plain {err}"
            + ("" if err_single is None else
               f", vs {c.frames} single-frame launches {err_single}")
            + (f"; H2 launches by kernel {h2}" if any(h2.values()) else "")
            + (f"; {c.note}" if c.note else ""))
        if err != 0.0 or err_single:
            raise AssertionError(f"{c.name} [{c.variant}] differs from its "
                                 f"plain version or its single-frame "
                                 f"launches")
        bound_ms, bound_by = bound(c, out)
        results.append({"name": c.name, "variant": c.variant, "path": c.path,
                        "route": "cuda", "source": c.source,
                        "replaces": c.replaces, "max_abs_err": err,
                        "bound_ms": bound_ms / c.frames, "bound_by": bound_by,
                        # no one PyTorch call computes an SGM scan, a fused
                        # cost + box + scan, BRIEF's sampling and packing,
                        # connected components, a greedy clique or a Kabsch
                        # fit; an SVD's is torch.linalg.svd
                        "library_ms": None if c.library is None else min(
                            time_ms(torch, c.library, 20),
                            time_ms(torch, c.library, 20)) / c.frames})
        if c.frames > 1:
            results[-1]["frames"] = c.frames
        if any(h2.values()):
            results[-1]["h2_kernels"] = h2
    # times: plain, kernel, kernel, plain, each by CUDA events
    for r, c in zip(results, cases):
        reps_plain = {"brief_describe": 20, "corner_keys": 5}.get(c.name, 1)
        t_p1 = time_ms(torch, c.plain, reps_plain)
        t_k1 = time_ms(torch, c.kern, 20)
        t_k2 = time_ms(torch, c.kern, 20)
        t_p2 = time_ms(torch, c.plain, reps_plain)
        r["ms"] = min(t_k1, t_k2) / c.frames
        r["plain_ms"] = min(t_p1, t_p2) / c.frames
        if c.device:
            r["device_ms"] = min(device_ms(torch, c.kern),
                                 device_ms(torch, c.kern))
            r["plain_device_ms"] = device_ms(torch, c.plain, 2)
        earlier = BLOCK_WALK_MS.get((c.name, c.variant))
        first = FIRST_DESIGN_MS.get((c.name, c.variant))
        single = ""
        if c.frames > 1:
            # the same frames by single-frame launches back to back, timed
            # between the batched rounds' neighbours
            run = c.single_run or c.single
            t_s = min(time_ms(torch, run, 5), time_ms(torch, run, 5))
            r["single_frame_ms"] = t_s / c.frames
            single = (f"; a frame {r['ms']:.4f} ms, by {c.frames} "
                      f"single-frame launches back to back "
                      f"{r['single_frame_ms']:.4f} ms")
        log(f"[kernels] {c.name} [{c.variant}]: kernel {t_k1:.4f} / "
            f"{t_k2:.4f} ms"
            + ("" if earlier is None else
               f" (redesigned; the block walk: {earlier} ms)")
            + ("" if first is None else
               f" (redesigned; the first design: {first} ms a frame)")
            + f", plain {t_p1:.4f} / {t_p2:.4f} ms, bound "
            f"{r['bound_ms'] * c.frames:.4f} ms ({r['bound_by']})" + single
            + ("" if not c.device else
               f"; device time {r['device_ms']:.4f} ms, plain "
               f"{r['plain_device_ms']:.4f} ms"))
    return results


def check_plain_stages(torch, seq, cam):
    """The plain PyTorch stages of the paths, on frame 0 and on frames 0-15
    as one batch: the time and peak memory of block13's float32 cost
    volume and box sum, and H6's pyramid against the CPU's."""
    from openvo_tpu_torch.ops import sgbm, sgbm_cuda
    from openvo_tpu_torch.ops.remap import remap_bilinear

    left, right = (
        remap_bilinear(torch.as_tensor(seq[side][0], device=cam.device)
                       .to(torch.float32), *maps)
        for side, maps in (("left", cam.map_left), ("right", cam.map_right)))
    q = path_params("block13")
    cap = max(q.pre_filter_cap, 15) | 1
    lp, rp = sgbm.prefilter_xsobel(left, cap), sgbm.prefilter_xsobel(right,
                                                                     cap)
    cost_args = (lp, rp, q.min_disparity, q.num_disparities, q.block_size,
                 cap, True)
    gc.collect()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cost_ms = time_ms(torch, lambda: sgbm_cuda.cost_volume_f32(*cost_args), 5)
    cost_mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    log(f"[cost_volume_f32] block13's float32 cost volume and box sum: "
        f"{cost_ms:.4f} ms on the card, {cost_mib:.1f} MiB at its peak")

    # the same stage over frames 0-15 as one batch, as block13-tp runs it
    lefts, rights = (torch.stack([
        remap_bilinear(torch.as_tensor(seq[side][i], device=cam.device)
                       .to(torch.float32), *maps) for i in range(BATCH)])
        for side, maps in (("left", cam.map_left), ("right", cam.map_right)))
    lps, rps = sgbm.prefilter_xsobel(lefts, cap), sgbm.prefilter_xsobel(
        rights, cap)
    gc.collect()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cost_ms_b = time_ms(torch, lambda: sgbm_cuda.cost_volume_f32(
        lps, rps, *cost_args[2:]), 2) / BATCH
    cost_mib_b = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    log(f"[cost_volume_f32] over frames 0-{BATCH - 1} as one batch: "
        f"{cost_ms_b:.4f} ms a frame on the card, {cost_mib_b:.1f} MiB at "
        f"its peak")
    resize_against_cpu(torch, seq, cam)
    return [{"name": "cost_volume_f32", "variant": "float32, block 13, plain "
             "PyTorch", "route": "torch",
             "source": "openvo_tpu_torch/ops/sgbm_cuda.py",
             "replaces": "openvo_tpu/ops/sgbm.py:555-558 (XLA)",
             "ms": cost_ms, "peak_mib": cost_mib,
             "batch_ms_a_frame": cost_ms_b, "batch_peak_mib": cost_mib_b}]


def resize_against_cpu(torch, seq, cam):
    """ORB's pyramid of frame 0 by H6 on the card against its plain
    version on the CPU: bit-equal (one fixed order of multiply-adds)."""
    from openvo_tpu_torch.config import ORBParams
    from openvo_tpu_torch.ops import orb, orb_cuda

    img = torch.as_tensor(seq["left"][0], device=cam.device).to(
        torch.float32)
    dims = tuple(orb._level_dims(*img.shape, ORBParams()))
    err = max_abs_err(orb_cuda.resize_levels(img, dims).cpu(),
                      orb_cuda.resize_levels_plain(img.cpu(), dims))
    log(f"[resize] frame 0's pyramid by H6 on the card against the plain "
        f"version on the CPU: max |diff| {err}")
    if err != 0.0:
        raise AssertionError("H6 on the card differs from the CPU's levels")


def time_k4_library(torch, dev, smi):
    """K4 (``lr_lookup``: d_r[h, x] = best_r[h, x - best[h, x]]) as one
    PyTorch call, ``torch.gather`` along x at (376, 1242) int32, timed by
    CUDA events. H3 does this lookup from shared memory in its epilogue;
    the call is timed here for PERF.md's table and used nowhere in the
    port. Disparities of frame 0's off-lat WTA range (0-127)."""
    H, W = IMG_SIZE[1], IMG_SIZE[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    best = torch.randint(0, 128, (H, W), generator=gen, device=dev,
                         dtype=torch.int32)
    best_r = torch.randint(0, 128, (H, W), generator=gen, device=dev,
                           dtype=torch.int32)
    x = torch.arange(W, device=dev, dtype=torch.int32)
    idx = (x - best).clamp_min(0).long()   # built once: the call is the lookup

    def call():
        return torch.gather(best_r, 1, idx)

    d_r = call()
    want = best_r.cpu().numpy()[np.arange(H)[:, None], np.maximum(
        np.arange(W) - best.cpu().numpy(), 0)]
    if not np.array_equal(d_r.cpu().numpy(), want):
        raise AssertionError("K4's gather disagrees with numpy")
    ms = min(time_ms(torch, call, 50), time_ms(torch, call, 50))
    log(f"[kernels] K4 lr_lookup as torch.gather at ({H}, {W}) int32: "
        f"{ms:.4f} ms (library call; in the port it is H3's epilogue); "
        f"{smi}")
    return {"name": "lr_lookup", "variant": "torch.gather (library call)",
            "route": "torch", "source": "chip_smoke.py",
            "replaces": f"{PALLAS_SGBM}:827", "library_ms": ms}


def expected_launches(params, filters=False):
    """Each kernel's launches per frame on a single-device path: H7 with
    the speckle filter on, H8 (one launch for both attempts' clouds) with
    the rigid clique on, H10 once for both attempts' fits (twice with the
    outlier pass), H11 and H12 never (mono's alone)."""
    from openvo_tpu_torch.ops import sgbm

    f32 = sgbm.int16_sentinel(params.block_size,
                              max(params.pre_filter_cap, 15) | 1) is None
    dirs = 1 if params.num_paths == 4 else 3
    ways = 1 if params.num_paths == 5 else 2
    speckle = params.speckle_window_size > 0 and params.speckle_range > 0
    # H2: one launch a direction over float32 C; over int16 C one launch
    # for every line, or the trio walk's one a direction of travel
    trio = h2_design(params, 1) == "trio"
    return {"cost_hsweep": 0 if f32 else 1, "hsweep": int(f32),
            "vsweep": dirs * ways if f32 else (ways if trio else 1),
            "hsweep_wta_lr": 1,
            "brief_describe": 1, "resize_levels": 1, "corner_keys": 1,
            "speckle_keep": int(speckle), "greedy_clique": int(filters),
            "kabsch_fit": 2 if filters else 1, "jacobi_svd": 0,
            "five_point_roots": 0}


def h2_design(params, frames):
    """The H2 kernel ``ops/sgbm_cuda.vsweep_design`` gives a path's calls:
    ``frames`` frames a call at the path's SGBM parameters, at IMG_SIZE."""
    import torch

    from openvo_tpu_torch.ops import sgbm, sgbm_cuda

    f32 = sgbm.int16_sentinel(params.block_size,
                              max(params.pre_filter_cap, 15) | 1) is None
    return sgbm_cuda.vsweep_design(
        torch.float32 if f32 else torch.int16, params.num_paths != 4, False,
        True, params.num_disparities, IMG_SIZE[0], frames)


def h2_kernels(call):
    """``call()``, an untimed call, recorded by the trace from an empty
    ring, and its H2 launches by kernel from their trace counters
    (``ovo.vsweep_trio``: the trio walk, ``ovo.vsweep``: the line walk);
    recording is left on or off as it was."""
    from openvo_tpu_torch import trace

    was = trace.recording()
    trace.clear()
    trace.enable()
    try:
        out = call()
        got = {"trio": 0, "lines": 0}
        for r in trace.records():
            if r.name in ("ovo.vsweep_trio", "ovo.vsweep"):
                got["trio" if r.name == "ovo.vsweep_trio" else "lines"] += r.n
    finally:
        if not was:
            trace.disable()
    return out, got


def check_h2_designs(name, params, frames, call):
    """Run ``call``, one more call of a path outside its timed run, log
    how many of its H2 launches took each kernel (:func:`h2_kernels`) and
    fail unless every one took the kernel :func:`h2_design` gives the
    path."""
    from openvo_tpu_torch.ops import sgbm_cuda

    n0 = sgbm_cuda.vsweep.launches
    _, got = h2_kernels(call)
    launched = sgbm_cuda.vsweep.launches - n0
    want = h2_design(params, frames)
    log(f"[{name}] H2 launches by kernel: {got} (vsweep_design: {want} for "
        f"{frames} frames a call)")
    if not launched or got[want] != launched or sum(got.values()) != launched:
        raise AssertionError(f"{name}: H2's {launched} launches took {got}, "
                             f"expected the {want} kernel")


def all_kernels():
    """Every kernel wrapper of the port (each with its launch count)."""
    from openvo_tpu_torch.ops import (clique_cuda, fivepoint_cuda,
                                      jacobi_cuda, orb_cuda, sgbm_cuda,
                                      speckle_cuda)

    return (sgbm_cuda.KERNELS + orb_cuda.KERNELS + speckle_cuda.KERNELS
            + clique_cuda.KERNELS + jacobi_cuda.KERNELS
            + fivepoint_cuda.KERNELS)


def plain_tripwires():
    """The plain versions of every kernel, and torch.linalg.svd, as
    (module, name): a path runs with each replaced by a function that
    fails."""
    import torch

    from openvo_tpu_torch.ops import orb, orb_cuda, sgbm, sgbm_cuda
    from openvo_tpu_torch.pose import fivepoint, kabsch, rigid_clique

    return {(sgbm_cuda, "cost_hsweep_plain"), (sgbm_cuda, "vsweep_plain"),
            (sgbm_cuda, "hsweep_plain"), (sgbm_cuda, "hsweep_wta_lr_plain"),
            (orb_cuda, "brief_describe_plain"),
            (orb_cuda, "resize_levels_plain"),
            (orb, "corner_keys_plain"),
            (sgbm, "speckle_keep_plain"),
            (rigid_clique, "greedy_clique_plain"),
            (kabsch, "kabsch_fit_plain"), (kabsch, "rotation_3x3_plain"),
            (kabsch, "jacobi_svd_plain"),
            (fivepoint, "five_point_roots_plain"),
            (torch.linalg, "svd")}


def tripwire(*_a, **_k):
    raise AssertionError("a plain version ran on the main path")


def odometer_kwargs(name):
    from openvo_tpu_torch import OdometerConfig, ORBParams

    if name == "filters":
        return dict(FILTERS)
    if name == "cv2rank":
        return {"config": OdometerConfig(orb=ORBParams(cv2_ranking=True))}
    return {}


def jax_reference():
    """The JAX package's `cv2rank` and `mono` runs (JAX_REFERENCE)."""
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        JAX_REFERENCE)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def run_path(torch, seq, name, smi):
    """Phase 3 for one path: the odometer over the sequence with the plain
    versions disabled; returns launch counts per kernel name and, frame by
    frame, ok, the skip cause and c_T_w."""
    from openvo_tpu_torch import StereoCamera, StereoOdometer, _graph
    from openvo_tpu_torch.ops import sgbm
    from openvo_tpu_torch.pose import rigid_clique

    kernels = all_kernels()
    plains = plain_tripwires()
    params = path_params(name)
    cam = StereoCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                       {"R": seq["R"], "T": seq["T"]}, params, IMG_SIZE,
                       device=DEVICE)
    saved = {(m, n): getattr(m, n) for m, n in plains}
    for m, n in plains:
        setattr(m, n, tripwire)
    odo = StereoOdometer(cam, **odometer_kwargs(name))
    oks, causes, poses, ctws, lat = [], [], [], [], []
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    try:
        with _graph.disable_capture():
            sgbm.speckle_filter.syncs = 0
            rigid_clique.rigid_body_filter.syncs = 0
            for k in kernels:
                k.launches = 0
            for i in range(N_FRAMES):
                t0 = time.perf_counter()
                oks.append(odo.update(seq["left"][i], seq["right"][i]))
                lat.append(time.perf_counter() - t0)   # ends in a sync
                causes.append(odo.skip_cause)
                ctws.append(odo.c_T_w)   # current_pose() is its inverse
                poses.append(np.linalg.inv(ctws[-1].astype(np.float64)))
            launches = {k.__name__: k.launches for k in kernels}
            syncs = sgbm.speckle_filter.syncs
            clique_syncs = rigid_clique.rigid_body_filter.syncs
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            check_h2_designs(name, params, 1, lambda: odo.update(
                seq["left"][0], seq["right"][0]))
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
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
        f"at the start, peak {peak:.1f} MiB; {smi}")
    log(f"[{name}] kernel launches: {launches}; speckle host syncs "
        f"{syncs} ({syncs / N_FRAMES} a frame); rigid clique host syncs "
        f"{clique_syncs} ({clique_syncs / N_FRAMES} a frame); "
        f"{mode_line(name, odo.captured)}")
    no_loop_syncs(name, syncs, clique_syncs)
    if not np.isfinite(poses).all():
        raise AssertionError(f"{name}: non-finite pose")
    if name == "filters":
        check_against_jax(name, tracked, ate, causes, FILTERS_JAX,
                          FILTERS_ATE_TOL, FILTERS_CAUSES_DIFFERING)
    if name == "cv2rank":
        ref = jax_reference()
        want = {"tracked": int(ref["cv2rank_ok"].sum()),
                "ate_m": float(ref["cv2rank_ate_m"]),
                "causes": [str(c) for c in ref["cv2rank_causes"]]}
        check_against_jax(name, tracked, ate, causes, want, CV2RANK_ATE_TOL,
                          CV2RANK_CAUSES_DIFFERING)
    _, min_tracked, max_ate = PATHS[name]
    if min_tracked is not None and tracked < min_tracked:
        raise AssertionError(f"{name}: {tracked} frames tracked, below "
                             f"{min_tracked}")
    if max_ate is not None and not ate <= max_ate:
        raise AssertionError(f"{name}: ATE {ate} m above {max_ate}")
    for k, per_frame in expected_launches(params,
                                          name == "filters").items():
        if launches[k] != per_frame * N_FRAMES:
            raise AssertionError(f"{name}: {k} launched {launches[k]} times "
                                 f"in {N_FRAMES} frames, expected "
                                 f"{per_frame} a frame")
    return launches, {"ok": oks, "causes": causes, "c_T_w": np.stack(ctws),
                      "poses": poses, "lat": lat}


def mode_line(name, captured):
    """The eager run's mode, logged for every path: each runs eagerly here
    (``_graph.disable_capture``) and captured in its own run."""
    if captured is not False:
        raise AssertionError(f"{name}: ran captured={captured} where the "
                             f"eager run was due")
    return "mode: eager (capture disabled; the captured run follows)"


def no_loop_syncs(name, speckle, clique):
    """Fail unless the speckle filter's and the rigid clique's loops made
    no host sync: on the card they are H7 and H8."""
    if speckle or clique:
        raise AssertionError(f"{name}: the speckle filter synced {speckle} "
                             f"times and the rigid clique {clique} times on "
                             f"the card")


def count_syncs(torch, fn):
    """(fn(), its synchronizing calls, fn's own host-clock seconds), the
    calls counted with CUDA's sync debug mode."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            out = fn()
            secs = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught), secs


def held_bit_equal(name, ok, causes, ctws, ref):
    """The captured run of ``name`` against its eager run ``ref``: ok, skip
    cause and c_T_w equal at every frame it ran, bit for bit."""
    ctws = np.asarray(ctws)
    bad = [i for i in range(len(ok)) if ok[i] != ref["ok"][i]
           or causes[i] != ref["causes"][i]
           or not np.array_equal(ctws[i], ref["c_T_w"][i], equal_nan=True)]
    log(f"[{name} captured] against the eager run: frames differing in ok, "
        f"skip cause or c_T_w bits {bad}")
    if bad:
        raise AssertionError(f"{name}: the captured run differs from the "
                             f"eager one at frames {bad}")


def log_captured(name, eager_ms, captured_ms, syncs, unit, smi):
    """Log a captured path's medians and syncs, with the seconds of the
    last graph's warm-up and capture (the trace's last ``ovo.capture``
    span: the path's own, captured on its first call)."""
    from openvo_tpu_torch import trace

    caps = [r for r in trace.records() if r.name == "ovo.capture"]
    capture_s = (caps[-1].end - caps[-1].start) / 1e9 if caps else None
    log(f"[{name} captured] median {unit} eager {eager_ms} ms, captured "
        f"{captured_ms} ms; warm-up + capture {capture_s} s; host syncs "
        f"{syncs}; {smi}")


def replay_profile(torch, name, fn, calls=4, unit="a frame", per_call=1):
    """Log the device's work in a captured call, fn() (one graph replay and
    the copy of its results), over ``calls`` calls under torch.profiler:
    CUDA kernels and their device ms ``unit`` (a call covers
    ``per_call`` frames), and that time over the calls' host-clock time,
    the card's busy share."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, device_us, by_name = 0, 0.0, {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith(("Memcpy", "Memset"))):
            kernels += 1
            device_us += e.device_time_total
            key = e.name[:70]
            count, us = by_name.get(key, (0, 0.0))
            by_name[key] = (count + 1, us + e.device_time_total)
    n = calls * per_call
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    log(f"[{name} captured] under torch.profiler ({calls} calls): "
        f"{kernels / n} kernels and {device_us / 1e3 / n} ms of kernel time "
        f"{unit}, {wall * 1e3 / n} ms of host clock {unit}; the card busy "
        f"{device_us / 1e6 / wall if wall else 0.0} of it (kernels summed, "
        f"0 kernels: the profiler saw no replayed kernel); the most kernel "
        f"time {unit}, (kernels, ms) by name: "
        f"{[(k, c / n, us / 1e3 / n) for k, (c, us) in top]}")


def run_captured(torch, seq, name, smi, ref):
    """A single-frame path of PATHS as users run it: each update one
    replayed CUDA graph, the plain versions disabled; held to its eager run
    ``ref`` bit for bit, each of frames 2-63 one host sync (the copy of
    the update's results)."""
    from openvo_tpu_torch import StereoCamera, StereoOdometer

    cam = StereoCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                       {"R": seq["R"], "T": seq["T"]}, path_params(name),
                       IMG_SIZE, device=DEVICE)
    odo = StereoOdometer(cam, **odometer_kwargs(name))
    saved = {(m, n): getattr(m, n) for m, n in plain_tripwires()}
    for m, n in saved:
        setattr(m, n, tripwire)
    oks, causes, ctws, lat, syncs = [], [], [], [], []
    try:
        for i in range(N_FRAMES):
            ok, n, secs = count_syncs(torch, lambda: odo.update(
                seq["left"][i], seq["right"][i]))
            if not odo.captured:
                raise AssertionError(f"{name}: frame {i} ran eagerly")
            oks.append(ok)
            lat.append(secs)
            syncs.append(n)
            causes.append(odo.skip_cause)
            ctws.append(odo.c_T_w)
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
    replay_profile(torch, name, lambda: odo.update(seq["left"][-1],
                                                   seq["right"][-1]))
    log_captured(name, float(np.median(ref["lat"][2:])) * 1e3,
                 float(np.median(lat[2:])) * 1e3,
                 f"{sum(syncs[2:]) / (N_FRAMES - 2)} a frame of frames 2-"
                 f"{N_FRAMES - 1} (frame 0, capturing: {syncs[0]})",
                 "update latency", smi)
    held_bit_equal(name, oks, causes, ctws, ref)
    if set(syncs[2:]) != {1}:
        raise AssertionError(f"{name}: captured frames' host syncs "
                             f"{syncs[2:]}, expected 1 a frame")
    if name == "off-lat":
        two_on_one_camera(torch, cam, seq, ref)


def two_on_one_camera(torch, cam, seq, ref, frames=SHARED_FRAMES):
    """Two odometers on one camera share its captured step, as JAX's
    share the jitted one: updated in turns, each must give the eager
    run's first ``frames`` frames bit for bit (the step's buffers hold one
    odometer's state at a time; the other keeps a copy)."""
    from openvo_tpu_torch import StereoOdometer

    odos = [StereoOdometer(cam), StereoOdometer(cam)]
    got = [([], [], []) for _ in odos]
    for i in range(frames):
        for odo, (oks, causes, ctws) in zip(odos, got):
            oks.append(odo.update(seq["left"][i], seq["right"][i]))
            causes.append(odo.skip_cause)
            ctws.append(odo.c_T_w)
    if len(cam._step_cache) != 1 or not all(o.captured for o in odos):
        raise AssertionError("off-lat: two odometers of one camera did not "
                             "share one captured step")
    for k, (oks, causes, ctws) in enumerate(got):
        held_bit_equal(f"off-lat odometer {k} of 2 on one camera", oks,
                       causes, ctws, ref)


def check_against_jax(name, tracked, ate, causes, want, ate_tol,
                      differing):
    """A path against the JAX package's run of it: frames tracked within 1,
    the skip cause equal at all frames but ``differing``, the ATE within
    ``ate_tol`` m."""
    log(f"[{name}] skip causes, frame by frame:\n  port {causes}\n  JAX  "
        f"{want['causes']}")
    log(f"[{name}] tracked {tracked} (JAX {want['tracked']}), ATE {ate} m "
        f"(JAX {want['ate_m']} m)")
    if abs(tracked - want["tracked"]) > 1:
        raise AssertionError(f"{name}: {tracked} frames tracked, JAX "
                             f"{want['tracked']}")
    differ = [i for i, (a, b) in enumerate(zip(causes, want["causes"],
                                               strict=True)) if a != b]
    if len(differ) > differing:
        raise AssertionError(f"{name}: skip causes differ from JAX's at "
                             f"frames {differ}")
    if not abs(ate - want["ate_m"]) <= ate_tol:
        raise AssertionError(f"{name}: ATE {ate} m, JAX {want['ate_m']} m")


def motion_gaps(poses, ref_poses):
    """Per frame, the rotation (rad) and the angle between translation
    directions (rad) of the motion from the previous frame, against the
    reference's. The rotation is 2 asin(|Ra - Rb|_F / 2 sqrt 2), which
    stays exact for small angles where the trace's arccos of float32
    rotations has a floor near 4e-4 rad."""
    rot, ang = [0.0], [0.0]
    for i in range(1, len(poses)):
        a = np.linalg.inv(poses[i - 1]) @ poses[i]
        b = np.linalg.inv(ref_poses[i - 1]) @ ref_poses[i]
        rot.append(float(2 * np.arcsin(min(1.0, np.linalg.norm(
            a[:3, :3] - b[:3, :3]) / (2 * np.sqrt(2))))))
        na, nb = np.linalg.norm(a[:3, 3]), np.linalg.norm(b[:3, 3])
        ang.append(float(np.arccos(np.clip(
            a[:3, 3] @ b[:3, 3] / max(na * nb, 1e-12), -1.0, 1.0)))
            if na > 0 and nb > 0 else 0.0)
    return np.asarray(rot), np.asarray(ang)


def run_mono(torch, seq, name, smi, profiled=4):
    """Phase 4: MonoOdometer.update over the left images with the plain
    versions and torch.linalg.svd disabled, ``trans_scale`` the
    ground-truth step; `mono` replays the uniforms of JAX's draws,
    `mono-own` draws its own. First eagerly (``_graph.disable_capture()``):
    held to the JAX package's run, its launch counts per kernel name
    returned; then as users run it, each update one replayed CUDA graph,
    held to the eager run bit for bit (ok, skip code, c_T_w), one host sync
    a frame of frames 2-63 and none from pose/."""
    from openvo_tpu_torch import _graph
    from openvo_tpu_torch.models.mono_odometer import (MONO_SKIP_STRINGS,
                                                       MonoOdometer,
                                                       ransac_samples)
    from openvo_tpu_torch.ops import orb_cuda, sgbm_cuda

    ref = jax_reference()
    if ransac_samples(256) != MONO_ITERS or ref["mono_u"].shape[1:] != (
            MONO_ITERS, 5):
        raise AssertionError("the reference's draws do not fit the odometer")
    replay = name == "mono"
    kernels = all_kernels()
    saved = {(m, n): getattr(m, n) for m, n in plain_tripwires()}
    for m, n in saved:
        setattr(m, n, tripwire)
    us = [torch.from_numpy(u).to(DEVICE) for u in ref["mono_u"]]

    def update(odo, i):
        return odo.update(seq["left"][i], trans_scale=SEQ["step"],
                          u=us[i] if replay else None)

    odo = MonoOdometer(seq["K"], device=DEVICE)
    accepted, codes, poses, ctws, lat = [], [], [], [], []
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    try:
        with _graph.disable_capture():
            for k in kernels:
                k.launches = 0
            for i in range(N_FRAMES):
                t0 = time.perf_counter()
                accepted.append(update(odo, i))
                lat.append(time.perf_counter() - t0)   # ends in a sync
                if odo.captured:
                    raise AssertionError(f"{name}: frame {i} ran captured")
                codes.append(int(odo.last_stats["skip_code"]))
                ctws.append(odo.state.c_T_w.cpu().numpy())
                poses.append(odo.current_pose())
            launches = {k.__name__: k.launches for k in kernels}
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            # launches and synchronizing calls a frame, from the profiler,
            # over frames run again outside the timed loop
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                for i in range(profiled):
                    odo.update(seq["left"][i], trans_scale=SEQ["step"])
                torch.cuda.synchronize()
            syncs = sync_sources(torch, lambda: odo.update(
                seq["left"][min(profiled, N_FRAMES - 1)],
                trans_scale=SEQ["step"]))
        eager = {"ok": accepted, "causes": codes, "c_T_w": np.stack(ctws),
                 "lat": lat}
        run_mono_captured(torch, seq, name, smi, update, eager)
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
    avg = prof.key_averages()
    per_frame = {e.key: e.count / profiled for e in avg
                 if "LaunchKernel" in e.key or "Synchronize" in e.key
                 or "Memcpy" in e.key}
    device_ms = sum(e.self_device_time_total for e in avg) / 1e3 / profiled
    poses = np.stack(poses)
    gt = np.asarray(seq["T_wc"], np.float64)
    ate = float(np.mean(np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3],
                                       axis=1)))
    n_acc = int(sum(accepted))
    med = float(np.median(lat[2:])) * 1e3
    want_codes = [int(c) for c in ref["mono_code"]]
    want_acc = int(ref["mono_accept"].sum())
    log(f"[{name}] accepted {n_acc}/{N_FRAMES} (JAX {want_acc}), ATE {ate} "
        f"m (JAX {float(ref['mono_ate_m'])} m) over "
        f"{SEQ['step'] * (N_FRAMES - 1)} m, eager per-frame update latency "
        f"median {med} ms (frames 2-{N_FRAMES - 1}), min "
        f"{min(lat[2:]) * 1e3} ms, max {max(lat[2:]) * 1e3} ms, first frame "
        f"{lat[0] * 1e3} ms; device memory allocated {base:.1f} MiB at the "
        f"start, peak {peak:.1f} MiB; {smi}")
    log(f"[{name}] kernel launches: {launches} ({launches['brief_describe']}"
        f" H4 in {N_FRAMES} frames); per eager frame under torch.profiler "
        f"({profiled} frames): {per_frame}, device time {device_ms:.3f} ms; "
        f"synchronizing calls in one eager frame, by the line that made "
        f"them: {syncs}")
    log(f"[{name}] skip codes where either is not 0: port "
        f"{[(i, MONO_SKIP_STRINGS[c]) for i, c in enumerate(codes) if c]}, "
        f"JAX {[(i, c) for i, c in enumerate(want_codes) if c]}")
    if not np.isfinite(poses).all():
        raise AssertionError(f"{name}: non-finite pose")
    stray = [k for k in syncs if k.startswith("openvo_tpu_torch/pose/")]
    if stray:
        raise AssertionError(f"{name}: host syncs in RANSAC at {stray}")
    log(f"[{name}] H12 launches: {launches['five_point_roots']} in "
        f"{N_FRAMES} eager frames")
    if (any(launches[k.__name__] != N_FRAMES for k in orb_cuda.KERNELS)
            or any(launches[k.__name__] for k in sgbm_cuda.KERNELS)
            or launches["jacobi_svd"] != MONO_SVDS * N_FRAMES
            or launches["five_point_roots"] != N_FRAMES
            or launches["kabsch_fit"]):
        raise AssertionError(f"{name}: launches {launches}, expected H4, "
                             f"H6, H9 and H12 once a frame, H11 "
                             f"{MONO_SVDS} times, no SGBM kernel and no "
                             f"H10")
    if replay:
        ref_poses = np.linalg.inv(ref["mono_c_T_w"].astype(np.float64))
        rot, ang = motion_gaps(poses, ref_poses)
        off = np.nonzero(ang > MONO_DIR_OFF)[0].tolist()
        log(f"[{name}] against JAX's poses: each frame's motion rotated by "
            f"median {float(np.median(rot))} rad (max {float(rot.max())} at "
            f"frame {int(rot.argmax())}), its direction by median "
            f"{float(np.median(ang))} rad (max {float(ang.max())} at frame "
            f"{int(ang.argmax())}; frames beyond {MONO_DIR_OFF} rad: {off});"
            f" positions up to "
            f"{float(np.abs(poses[:, :3, 3] - ref_poses[:, :3, 3]).max())} m"
            f" apart")
        differ = [i for i, (a, b) in enumerate(zip(codes, want_codes))
                  if a != b]
        if abs(n_acc - want_acc) > MONO_ACCEPTED_WITHIN:
            raise AssertionError(f"{name}: {n_acc} frames accepted, JAX "
                                 f"{want_acc}")
        if len(differ) > MONO_CODES_DIFFERING:
            raise AssertionError(f"{name}: skip codes differ from JAX's at "
                                 f"frames {differ}")
        if not abs(ate - float(ref["mono_ate_m"])) <= MONO_ATE_TOL:
            raise AssertionError(f"{name}: ATE {ate} m, JAX "
                                 f"{float(ref['mono_ate_m'])} m")
        if not (np.median(rot) <= MONO_ROT_MEDIAN
                and np.median(ang) <= MONO_DIR_MEDIAN
                and len(off) <= MONO_DIR_OFF_FRAMES):
            raise AssertionError(f"{name}: motion off JAX's: median rotation "
                                 f"{np.median(rot)} rad, direction "
                                 f"{np.median(ang)} rad, frames beyond "
                                 f"{MONO_DIR_OFF} rad {off}")
    else:
        if n_acc < want_acc - MONO_OWN_ACCEPTED_BELOW:
            raise AssertionError(f"{name}: {n_acc} frames accepted, JAX "
                                 f"{want_acc}")
        if not abs(ate - float(ref["mono_ate_m"])) <= MONO_OWN_ATE_TOL:
            raise AssertionError(f"{name}: ATE {ate} m, JAX "
                                 f"{float(ref['mono_ate_m'])} m")
    return launches


def run_mono_captured(torch, seq, name, smi, update, eager):
    """A mono path as users run it: a new odometer (its generator seeded
    as the eager run's), each update one replayed CUDA graph; ok, skip
    code and c_T_w equal to the ``eager`` run's at every frame, one host
    sync a frame of frames 2-63, none of them in pose/; H12 launched in
    the first frame's warm-up and capture only; the replay's kernels and
    kernel time under torch.profiler."""
    from openvo_tpu_torch.models.mono_odometer import MonoOdometer
    from openvo_tpu_torch.ops import fivepoint_cuda

    odo = MonoOdometer(seq["K"], device=DEVICE)
    oks, codes, ctws, lat, syncs, h12 = [], [], [], [], [], []
    for i in range(N_FRAMES):
        n0 = fivepoint_cuda.five_point_roots.launches
        ok, n, secs = count_syncs(torch, lambda: update(odo, i))
        h12.append(fivepoint_cuda.five_point_roots.launches - n0)
        if not odo.captured:
            raise AssertionError(f"{name}: frame {i} ran eagerly")
        oks.append(ok)
        lat.append(secs)
        syncs.append(n)
        codes.append(int(odo.last_stats["skip_code"]))
        ctws.append(odo.state.c_T_w.cpu().numpy())
    pose_syncs = sync_sources(torch, lambda: update(odo, N_FRAMES - 1))
    replay_profile(torch, name, lambda: update(odo, N_FRAMES - 1))
    if len(odo._graphs) != 1:
        raise AssertionError(f"{name}: {len(odo._graphs)} graphs captured")
    log_captured(name, float(np.median(eager["lat"][2:])) * 1e3,
                 float(np.median(lat[2:])) * 1e3,
                 f"{sum(syncs[2:]) / (N_FRAMES - 2)} a frame of frames 2-"
                 f"{N_FRAMES - 1} (frame 0, capturing: {syncs[0]}); in one "
                 f"captured frame, by line: {pose_syncs}", "update latency",
                 smi)
    held_bit_equal(name, oks, codes, ctws, eager)
    log(f"[{name} captured] H12 launches: {h12[0]} in frame 0 (the warm-up "
        f"and the capture), {sum(h12[1:])} in frames 1-{N_FRAMES - 1}")
    if h12[0] != 2 or any(h12[1:]):
        raise AssertionError(f"{name}: captured H12 launches {h12}, "
                             f"expected 2 at the capture, then none")
    if set(syncs[2:]) != {1}:
        raise AssertionError(f"{name}: captured frames' host syncs "
                             f"{syncs[2:]}, expected 1 a frame")
    stray = [k for k in pose_syncs if k.startswith("openvo_tpu_torch/pose/")]
    if stray:
        raise AssertionError(f"{name}: captured host syncs in pose/ at "
                             f"{stray}")


def sync_sources(torch, fn):
    """Run fn() once with CUDA's sync debug mode on; the synchronizing
    calls it made, counted by the Python line that made them."""
    import collections
    import os
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    here = os.path.dirname(os.path.abspath(__file__))
    return dict(collections.Counter(
        f"{os.path.relpath(w.filename, here)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message)).most_common())


def _tiled_rank(rank, tmp, out_q, device, p, q, o):
    """One rank of phase 4: the tiled SGBM with parameters ``p`` over the
    frames, ``q`` on the shifted frame 0 and ``o`` (on-lat's, the speckle
    filter on) on frame 0, on ``device`` in a gloo group."""
    import datetime

    import torch
    import torch.distributed as dist

    from openvo_tpu_torch.parallel.tiling import make_tiled_sgbm_fn

    try:
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                                rank=rank, world_size=TILED_RANKS,
                                timeout=datetime.timedelta(seconds=300))
        data = np.load(f"{tmp}/inputs.npz")
        left, right = data["left"], data["right"]
        fn = make_tiled_sgbm_fn(p, device=device)
        fn(left[0], right[0])    # warm-up
        sync()
        dist.barrier()
        kernels = all_kernels()
        for k in kernels:
            k.launches = 0
        bands, lat = [], []
        for i in range(len(left)):
            dist.barrier()
            t0 = time.perf_counter()
            bands.append(fn(left[i], right[i]))
            sync()
            dist.barrier()
            lat.append(time.perf_counter() - t0)
        launches = {k.__name__: k.launches for k in kernels}
        # where a tiled frame's time goes: the first and last ranks under
        # torch.profiler for PROFILED frames (outside the timed loop)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(min(PROFILED, len(left))):
                fn(left[i], right[i])
                sync()
                dist.barrier()
        table = ""
        if rank in (0, TILED_RANKS - 1):
            avg = prof.key_averages()
            table = (avg.table(sort_by="cpu_time_total", row_limit=12)
                     + avg.table(sort_by="device_time_total", row_limit=8))
        fn13 = make_tiled_sgbm_fn(q, device=device)
        for k in kernels:
            k.launches = 0
        band13 = fn13(data["left13"], data["right13"])
        launches13 = {k.__name__: k.launches for k in kernels}
        fn_on = make_tiled_sgbm_fn(o, device=device)
        for k in kernels:
            k.launches = 0
        band_on = fn_on(left[0], right[0])
        launches_on = {k.__name__: k.launches for k in kernels}
        np.savez(f"{tmp}/rank{rank}.npz",
                 bands=torch.stack(bands).cpu().numpy(),
                 band13=band13.cpu().numpy(), band_on=band_on.cpu().numpy())
        dist.destroy_process_group()
        out_q.put((rank, {"launches": launches, "launches13": launches13,
                          "launches_on": launches_on,
                          "lat_ms": [t * 1e3 for t in lat],
                          "profile": table}))
    except BaseException as e:  # reported to the parent, which fails
        out_q.put((rank, {"error": f"{type(e).__name__}: {e}"}))
        raise


def run_tiled4(torch, seq, cam):
    """Phase 4: the row-tiled SGBM on TILED_RANKS ranks sharing the card,
    against the single-device disparity on the card: off-lat over the
    frames, block13 on the shifted frame 0, on-lat (H7 over the gathered
    frame on every rank) on frame 0. Returns launch counts summed over the
    ranks and the off-lat and on-lat runs."""
    from openvo_tpu_torch.ops import sgbm

    p, q = path_params("off-lat"), path_params("block13")
    o = path_params("on-lat")
    dev = cam.device
    refs = [sgbm.sgbm_disparity16(torch.as_tensor(seq["left"][i], device=dev),
                                  torch.as_tensor(seq["right"][i], device=dev),
                                  p).cpu().numpy() for i in range(N_FRAMES)]
    # block13 on frame 0, rectified and shifted: every pixel fractional
    from openvo_tpu_torch.ops.remap import remap_bilinear
    l13, r13 = (remap_bilinear(torch.as_tensor(seq[side][0], device=dev)
                               .to(torch.float32), mx + SHIFT, my + SHIFT)
                for side, (mx, my) in (("left", cam.map_left),
                                       ("right", cam.map_right)))
    ref13 = sgbm.sgbm_disparity16(l13, r13, q).cpu().numpy()
    ref_on = sgbm.sgbm_disparity16(
        torch.as_tensor(seq["left"][0], device=dev),
        torch.as_tensor(seq["right"][0], device=dev), o).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(f"{tmp}/inputs.npz", left=seq["left"], right=seq["right"],
                 left13=l13.cpu().numpy(), right13=r13.cpu().numpy())
        ctx = multiprocessing.get_context("spawn")
        out_q = ctx.Queue()
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_tiled_rank,
                             args=(r, tmp, out_q, dev.type, p, q, o))
                 for r in range(TILED_RANKS)]
        for pr in procs:
            pr.start()
        reports = {}
        try:
            deadline = time.perf_counter() + 600
            while len(reports) < TILED_RANKS:
                rank, rep = out_q.get(
                    timeout=max(1.0, deadline - time.perf_counter()))
                reports[rank] = rep
                if "error" in rep:
                    break
        finally:
            for pr in procs:
                pr.join(timeout=60)
                if pr.is_alive():
                    pr.kill()
        errors = {r: v["error"] for r, v in reports.items() if "error" in v}
        if errors:
            raise AssertionError(f"tiled4 ranks failed: {errors}")
        log(f"[tiled4] {TILED_RANKS} ranks ran in "
            f"{time.perf_counter() - t0:.1f} s (start-up included)")
        ranks = [np.load(f"{tmp}/rank{r}.npz") for r in range(TILED_RANKS)]
        tiled = np.concatenate([r["bands"] for r in ranks], axis=1)
        tiled13 = np.concatenate([r["band13"] for r in ranks])
        tiled_on = np.concatenate([r["band_on"] for r in ranks])
    neq = [int((tiled[i] != refs[i]).sum()) for i in range(N_FRAMES)]
    neq13 = int((tiled13 != ref13).sum())
    neq_on = int((tiled_on != ref_on).sum())
    lat = np.max([reports[r]["lat_ms"] for r in range(TILED_RANKS)], axis=0)
    log(f"[tiled4] off-lat, {N_FRAMES} frames, {IMG_SIZE[1] // TILED_RANKS} "
        f"rows a rank: pixels differing from the single-device disparity "
        f"{sum(neq)} (frames with any: {sum(n > 0 for n in neq)}); tiled "
        f"SGBM per frame (barrier to barrier) median "
        f"{float(np.median(lat[2:]))} ms, min {float(lat[2:].min())} ms, "
        f"max {float(lat[2:].max())} ms")
    log(f"[tiled4] block13 on the shifted frame 0: {neq13} pixels differ")
    log(f"[tiled4] on-lat (the speckle filter on) on frame 0: {neq_on} "
        f"pixels differ")
    for r in (0, TILED_RANKS - 1):
        log(f"[tiled4] rank {r}, {PROFILED} frames under torch.profiler:\n"
            f"{reports[r]['profile']}")
    for r in range(TILED_RANKS):
        log(f"[tiled4] rank {r} launches: off-lat "
            f"{reports[r]['launches']}; block13 {reports[r]['launches13']}; "
            f"on-lat {reports[r]['launches_on']}")
    if sum(neq) or neq13 or neq_on:
        raise AssertionError("tiled4 differs from the single-device "
                             "disparity")
    for r in range(TILED_RANKS):
        got = reports[r]["launches"]
        if got["cost_hsweep"] != N_FRAMES or got["vsweep"] != N_FRAMES:
            raise AssertionError(f"tiled4 rank {r}: band H1 / carry H2 "
                                 f"launched {got['cost_hsweep']} / "
                                 f"{got['vsweep']} times in {N_FRAMES} "
                                 f"frames")
        got13 = reports[r]["launches13"]
        if got13["hsweep"] != 1 or got13["vsweep"] != 3:
            raise AssertionError(f"tiled4 rank {r}: block13 launches {got13}")
        if reports[r]["launches_on"]["speckle_keep"] != 1:
            raise AssertionError(f"tiled4 rank {r}: on-lat launches "
                                 f"{reports[r]['launches_on']}")
    return {k: sum(reports[r][run][k] for r in range(TILED_RANKS)
                   for run in ("launches", "launches_on"))
            for k in reports[0]["launches"]}


def count_launches(torch, fn):
    """CUDA kernel launches fn() makes, from torch.profiler's
    LaunchKernel events."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if "LaunchKernel" in e.key)


def batched_path_kernels(launches, name, want, base="off-lat",
                         filters=False, steps=None):
    """Fail unless each kernel launched ``want`` times what a frame of the
    single-frame path ``base`` launches, on a batched path: H1-H4 ``want``
    times and H5 not at all at off-lat's parameters (H1, ``cost_hsweep``,
    is its two kernels bt_box and hwalk); H5, H3 and H4 ``want`` times, the
    float32 H2 three times that and H1 not at all at block13's; H7 ``want``
    times at on-lat's; H8 ``want`` times with ``filters``; H10 what a frame
    launches times the state machine's ``steps`` (``want`` unless given: a
    stream steps frame by frame)."""
    expected = {k: n * want for k, n in expected_launches(
        path_params(base), filters).items()}
    expected["kabsch_fit"] = expected_launches(
        path_params(base), filters)["kabsch_fit"] * (
        want if steps is None else steps)
    if launches != expected:
        raise AssertionError(f"{name}: launches {launches}, expected "
                             f"{expected}")


def path_camera(calib, base="off-lat"):
    """The camera of the single-frame path ``base`` (off-lat unless given)
    on the corridor's calibration (K, dist, R, T of the rendered sequence,
    or of a rank's inputs)."""
    from openvo_tpu_torch import StereoCamera

    return StereoCamera(calib["K"], calib["dist"], calib["K"], calib["dist"],
                        {"R": calib["R"], "T": calib["T"]},
                        path_params(base), IMG_SIZE, device=DEVICE)


def held_to_path(name, ok, causes, ctws, ref, base="off-lat", frames=None):
    """A path's per-frame ok, skip cause and c_T_w against the single-frame
    path ``base``'s record ``ref``."""
    frames = range(N_FRAMES) if frames is None else frames
    bad = [i for i in frames if ok[i] != ref["ok"][i]
           or causes[i] != ref["causes"][i]]
    gap = max(float(np.abs(ctws[i] - ref["c_T_w"][i]).max()) for i in frames)
    log(f"[{name}] against {base}: frames differing in ok or skip cause "
        f"{bad}; c_T_w up to {gap} apart (limit {POSE_TOL})")
    if bad or not gap <= POSE_TOL:
        raise AssertionError(f"{name}: differs from {base} at frames {bad}, "
                             f"c_T_w gap {gap}")


def run_stream(torch, seq, smi, name, ref):
    """A streamed path of STREAMS (off-tp, on-tp, block13-tp):
    ``make_stream_fn`` with chunk BATCH over the 64 frames, each chunk
    extracted batched (every kernel of the single-frame path, and the
    speckle filter's loop, once a chunk), the plain versions disabled, held
    to its single-frame path's run ``ref`` frame by frame. Returns launch
    counts per kernel name."""
    from openvo_tpu_torch import OdometerConfig, _graph
    from openvo_tpu_torch.config import SKIP_CAUSE_STRINGS
    from openvo_tpu_torch.models.stereo_odometer import (FrameFeatures,
                                                         init_state,
                                                         make_pipeline_fns)
    from openvo_tpu_torch.ops import orb, sgbm
    from openvo_tpu_torch.parallel.stream import make_stream_fn

    single = STREAMS[name]
    cam = path_camera(seq, single)
    cfg = OdometerConfig()
    kernels = all_kernels()
    stream = make_stream_fn(cam, cfg, chunk=BATCH)
    fns = make_pipeline_fns(cam, cfg, False)
    lefts = torch.as_tensor(seq["left"], device=cam.device)
    rights = torch.as_tensor(seq["right"], device=cam.device)

    def fresh():
        return init_state(cam.cropped_shape, cfg.orb.max_keypoints,
                          cam.device)

    def chunk0():
        return stream(fresh(), lefts[:BATCH], rights[:BATCH])

    saved = {(m, n): getattr(m, n) for m, n in plain_tripwires()}
    for m, n in saved:
        setattr(m, n, tripwire)
    try:
        with _graph.disable_capture():
            # first-call costs outside the timed run
            check_h2_designs(name, path_params(single), BATCH, chunk0)
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated() / 2 ** 20
            torch.cuda.reset_peak_memory_stats()
            for k in kernels:
                k.launches = 0
            sgbm.speckle_filter.syncs = 0
            t0 = time.perf_counter()
            _, (ok, ctw) = stream(fresh(), lefts, rights)
            ok, ctw = ok.cpu().numpy(), ctw.cpu().numpy()
            secs = time.perf_counter() - t0
            mode = mode_line(name, stream.captured)
            launches = {k.__name__: k.launches for k in kernels}
            speckle_syncs = sgbm.speckle_filter.syncs
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            # launches and host syncs a frame, over one chunk run again
            per_frame = count_launches(torch, chunk0) / BATCH
            syncs = sync_sources(torch, chunk0)
            # each frame's skip code: the stream's steps again, with stats
            state, causes, ok2, ctw2 = fresh(), [], [], []
            for c0 in range(0, N_FRAMES, BATCH):
                feats = fns["extract"](lefts[c0:c0 + BATCH],
                                       rights[c0:c0 + BATCH])
                for i in range(BATCH):
                    state, ok_i, stats = fns["step_feats"](
                        state, FrameFeatures(*(x[i] for x in feats)))
                    causes.append(
                        SKIP_CAUSE_STRINGS[int(stats["skip_code"])])
                    ok2.append(bool(ok_i))
                    ctw2.append(state.c_T_w.cpu().numpy())
            # the batched extract against the single-frame one, by frame
            batched = fns["extract"](lefts[:BATCH], rights[:BATCH])
            differ = {}
            for i in range(BATCH):
                one = fns["extract"](lefts[i], rights[i])
                for field in one._fields:
                    if not torch.equal(getattr(batched, field)[i],
                                       getattr(one, field)):
                        differ.setdefault(field, []).append(i)
            del batched, one
            # the plain stages' launches a frame, one frame against a chunk
            _, disp, img = cam.compute_3d_fn(False, False)(lefts[:BATCH],
                                                           rights[:BATCH])
            fmask = ((disp >= cfg.min_valid_disparity)
                     & (disp <= cfg.max_valid_disparity)).to(torch.uint8)
            stages = {}
            for stage, call in (
                    ("extract",
                     lambda x: fns["extract"](lefts[x], rights[x])),
                    ("ORB detect", lambda x: orb.detect(img[x], fmask[x],
                                                        cfg.orb))):
                stages[stage] = (count_launches(torch, lambda: call(0)),
                                 count_launches(torch, lambda: call(
                                     slice(0, BATCH))) / BATCH)
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
    tracked = int(ok.sum())
    n_syncs = sum(syncs.values()) / BATCH
    chunks = N_FRAMES // BATCH
    log(f"[{name}] chunk {BATCH}: tracked {tracked}/{N_FRAMES} (skipped: "
        f"{[(i, causes[i]) for i in range(N_FRAMES) if not ok[i]]}); "
        f"{N_FRAMES / secs} fps, {secs * 1e3 / N_FRAMES} ms a frame over "
        f"the {N_FRAMES} frames (host clock, one sync at the end); "
        f"{per_frame} kernel launches and {n_syncs} host syncs a frame "
        f"(one chunk under torch.profiler and sync debug mode); speckle "
        f"host syncs {speckle_syncs / chunks} a chunk; device memory "
        f"allocated {base:.1f} MiB at the start, peak {peak:.1f} MiB; {smi}")
    log(f"[{name}] kernel launches: {launches}; synchronizing calls in one "
        f"chunk, by the line that made them: {syncs}; {mode}")
    no_loop_syncs(name, speckle_syncs, 0)
    for stage, (one, batched) in stages.items():
        log(f"[{name}] {stage}: {one} launches for one frame, {batched} a "
            f"frame in a chunk of {BATCH}")
    log(f"[{name}] the batched extract of frames 0-{BATCH - 1} against "
        f"single-frame calls, fields differing by frame: {differ}")
    if {"disp", "kp_xy", "desc", "kp_valid"} & set(differ):
        raise AssertionError(f"{name}: the batched extract differs from the "
                             f"single-frame one: {differ}")
    if not (np.array_equal(ok, ok2) and np.abs(ctw - np.stack(ctw2)).max()
            <= POSE_TOL):
        raise AssertionError(f"{name}: the steps run again differ from the "
                             f"stream")
    held_to_path(name, ok, causes, ctw, ref, single)
    if name == "off-tp" and (tracked < 63 or ok[40]
                             or causes[40] != "bigdist"):
        raise AssertionError(f"off-tp: {tracked} tracked, frame 40 "
                             f"{causes[40]!r}")
    batched_path_kernels(launches, name, chunks, single, steps=N_FRAMES)
    return launches, {"ok": ok, "causes": causes, "c_T_w": ctw,
                      "ms": secs * 1e3 / N_FRAMES}


def run_captured_stream(torch, seq, smi, name, ref):
    """A streamed path of STREAMS as users run it: ``make_stream_fn`` with
    chunk BATCH, each chunk one replayed CUDA graph, the plain versions
    disabled. The first call captures; the second, over the 64 frames, must
    make no host sync and equal the eager run ``ref`` bit for bit."""
    from openvo_tpu_torch import OdometerConfig
    from openvo_tpu_torch.config import SKIP_CAUSE_STRINGS
    from openvo_tpu_torch.models.stereo_odometer import init_state
    from openvo_tpu_torch.parallel.stream import make_stream_fn

    cam = path_camera(seq, STREAMS[name])
    cfg = OdometerConfig()
    stream = make_stream_fn(cam, cfg, chunk=BATCH)
    lefts = torch.as_tensor(seq["left"], device=cam.device)
    rights = torch.as_tensor(seq["right"], device=cam.device)

    def fresh():
        return init_state(cam.cropped_shape, cfg.orb.max_keypoints,
                          cam.device)

    saved = {(m, n): getattr(m, n) for m, n in plain_tripwires()}
    for m, n in saved:
        setattr(m, n, tripwire)
    try:
        stream(fresh(), lefts, rights)   # captures the chunk's graph
        state = fresh()
        torch.cuda.synchronize()
        _, syncs, _ = count_syncs(torch, lambda: stream(state, lefts,
                                                        rights))
        state = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()   # timed as the eager run: to its copies
        _, (ok, ctw) = stream(state, lefts, rights)
        ok, ctw = ok.cpu().numpy(), ctw.cpu().numpy()
        secs = time.perf_counter() - t0
        if not stream.captured:
            raise AssertionError(f"{name}: the stream ran eagerly")
        codes = stream.skip_codes.cpu().numpy()
        chunk = (lefts[:BATCH], rights[:BATCH])
        replay_profile(torch, name, lambda: stream(state, *chunk)[1][0].cpu(),
                       calls=2, per_call=BATCH)
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
    log_captured(name, ref["ms"],
                 secs * 1e3 / N_FRAMES, f"{syncs} in a call over "
                 f"{N_FRAMES} frames", "ms a frame (host clock, a call over"
                 " the frames and the copies of its results)", smi)
    held_bit_equal(name, ok, [SKIP_CAUSE_STRINGS[c] for c in codes], ctw,
                   ref)
    if syncs:
        raise AssertionError(f"{name}: the captured stream synced {syncs} "
                             f"times")


def run_rig8(torch, seq, smi, name, ref):
    """A rig of RIGS (rig8, rig8-filters): ``RigOdometer`` with RIG_CAMERAS
    cameras over the 64 frames with its single-frame path's odometer
    settings, every camera fed the frame's pair but camera RIG_BLANK[0],
    fed a blank pair at frame RIG_BLANK[1]; the plain versions disabled.
    Cameras 0-6 are held to the single-frame path's run ``ref`` frame by
    frame; the blank camera must skip that frame as ``keypoints``, track
    the next against its retained frame, and track all but one frame fewer
    than ``ref``. Returns launch counts per kernel name."""
    from openvo_tpu_torch import OdometerConfig, _graph
    from openvo_tpu_torch.parallel.rig import RigOdometer
    from openvo_tpu_torch.pose import rigid_clique

    single = RIGS[name]
    cam = path_camera(seq)
    cfg = OdometerConfig(**odometer_kwargs(single))
    kernels = all_kernels()
    blank_cam, blank_frame = RIG_BLANK
    steps = rig_inputs(torch, seq, cam)
    saved = {(m, n): getattr(m, n) for m, n in plain_tripwires()}
    for m, n in saved:
        setattr(m, n, tripwire)
    rig = RigOdometer(cam, RIG_CAMERAS, cfg)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with _graph.disable_capture():
            for k in kernels:
                k.launches = 0
            rigid_clique.rigid_body_filter.syncs = 0
            record = drive_rig(torch, rig, steps, name)
            launches = {k.__name__: k.launches for k in kernels}
            clique_syncs = rigid_clique.rigid_body_filter.syncs
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            check_h2_designs(name, path_params(single), RIG_CAMERAS,
                             lambda: rig.update(*steps[-1]))
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
    oks, causes, lat = record["ok"], record["causes"], record["lat"]
    poses = np.linalg.inv(record["c_T_w"].astype(np.float64))
    secs = sum(lat)
    around = slice(blank_frame, blank_frame + 2)
    log(f"[{name}] {RIG_CAMERAS} cameras x {N_FRAMES} frames: "
        f"{RIG_CAMERAS * N_FRAMES / secs} camera-frames a second in all, "
        f"update median {float(np.median(lat[2:])) * 1e3} ms a step "
        f"(frames 2-{N_FRAMES - 1}), first {lat[0] * 1e3} ms; tracked per "
        f"camera {oks.sum(0).tolist()}; camera {blank_cam} at frames "
        f"{blank_frame}-{blank_frame + 1}: ok "
        f"{oks[around, blank_cam].tolist()}, causes "
        f"{[c[blank_cam] for c in causes[around]]}; "
        f"peak device memory {peak:.1f} MiB; {smi}")
    log(f"[{name}] kernel launches: {launches}; rigid clique host checks "
        f"{clique_syncs} ({clique_syncs / N_FRAMES} a step); "
        f"{mode_line(name, rig.captured)}")
    no_loop_syncs(name, 0, clique_syncs)
    for c in range(RIG_CAMERAS):
        if c == blank_cam:
            continue
        held_to_path(f"{name} camera {c}", oks[:, c], [x[c] for x in causes],
                     record["c_T_w"][:, c], ref, single)
    b = oks[:, blank_cam]
    if (b[blank_frame] or causes[blank_frame][blank_cam] != "keypoints"
            or not b[blank_frame + 1] or b.sum() < sum(ref["ok"]) - 1
            or not np.isfinite(poses).all()):
        raise AssertionError(f"{name}: camera {blank_cam} tracked {b.sum()},"
                             f" frames {blank_frame}-{blank_frame + 1} "
                             f"{b[blank_frame:blank_frame + 2]}")
    batched_path_kernels(launches, name, N_FRAMES,
                         filters=single == "filters")
    return launches, record


def rig_inputs(torch, seq, cam):
    """Each frame's (left, right) stacks of RIG_CAMERAS images on the card:
    every camera the frame's pair, camera RIG_BLANK[0] a blank pair at
    frame RIG_BLANK[1]."""
    blank_cam, blank_frame = RIG_BLANK
    steps = []
    for i in range(N_FRAMES):
        pair = []
        for side in ("left", "right"):
            t = torch.as_tensor(seq[side][i], device=cam.device)
            t = t.expand((RIG_CAMERAS,) + t.shape).clone()
            if i == blank_frame:
                t[blank_cam] = 0
            pair.append(t)
        steps.append(pair)
    return steps


def drive_rig(torch, rig, steps, name, captured=False):
    """The rig over the frames: per frame (frames, cameras) ok, skip
    causes, c_T_w, the update's host-clock seconds and its host syncs;
    ``captured``: every update must replay the graph."""
    from openvo_tpu_torch.config import SKIP_CAUSE_STRINGS

    oks, causes, ctws, lat, syncs = [], [], [], [], []
    for i in range(N_FRAMES):
        ok, n, secs = count_syncs(torch, lambda: rig.update(*steps[i]))
        if rig.captured != captured:
            raise AssertionError(f"{name}: frame {i} ran captured="
                                 f"{rig.captured}")
        oks.append(ok)   # update() ends in a sync
        lat.append(secs)
        syncs.append(n)
        causes.append([SKIP_CAUSE_STRINGS[int(c)]
                       for c in rig.last_stats["skip_code"]])
        ctws.append(rig.state.c_T_w.cpu().numpy())
    return {"ok": np.stack(oks), "causes": causes, "c_T_w": np.stack(ctws),
            "lat": lat, "syncs": syncs}


def run_captured_rig(torch, seq, smi, name, ref):
    """A rig of RIGS as users run it: each step one replayed CUDA graph
    for the RIG_CAMERAS cameras, the plain versions disabled; every camera
    held to the eager run ``ref`` bit for bit, each of steps 2-63 one host
    sync."""
    from openvo_tpu_torch import OdometerConfig
    from openvo_tpu_torch.parallel.rig import RigOdometer

    cam = path_camera(seq)
    rig = RigOdometer(cam, RIG_CAMERAS,
                      OdometerConfig(**odometer_kwargs(RIGS[name])))
    steps = rig_inputs(torch, seq, cam)
    saved = {(m, n): getattr(m, n) for m, n in plain_tripwires()}
    for m, n in saved:
        setattr(m, n, tripwire)
    try:
        got = drive_rig(torch, rig, steps, name, captured=True)
        replay_profile(torch, name, lambda: rig.update(*steps[-1]),
                       unit="a step")
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
    syncs = got["syncs"]
    log_captured(name, float(np.median(ref["lat"][2:])) * 1e3,
                 float(np.median(got["lat"][2:])) * 1e3,
                 f"{sum(syncs[2:]) / (N_FRAMES - 2)} a step of steps 2-"
                 f"{N_FRAMES - 1} (step 0, capturing: {syncs[0]})",
                 "update latency a step", smi)
    held_bit_equal(name, [tuple(x) for x in got["ok"]], got["causes"],
                   got["c_T_w"], {**ref, "ok": [tuple(x) for x in ref["ok"]]})
    if set(syncs[2:]) != {1}:
        raise AssertionError(f"{name}: captured steps' host syncs "
                             f"{syncs[2:]}, expected 1 a step")


def _shard_rank(rank, tmp, out_q, device):
    """One rank of shard4: the sharded trajectory over the frames in a gloo
    group, the plain versions disabled."""
    import datetime

    import torch
    import torch.distributed as dist

    from openvo_tpu_torch import OdometerConfig
    from openvo_tpu_torch.parallel.sharding import make_sharded_trajectory_fn

    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv",
                                rank=rank, world_size=SHARD_RANKS,
                                timeout=datetime.timedelta(seconds=300))
        data = np.load(f"{tmp}/inputs.npz")
        left, right = data["left"], data["right"]
        fn = make_sharded_trajectory_fn(path_camera(data),
                                        OdometerConfig())
        kernels = all_kernels()
        for m, n in plain_tripwires():
            setattr(m, n, tripwire)
        fn(left, right)   # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        traj, ok = fn(left, right)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
        dist.barrier()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn(left, right)
            torch.cuda.synchronize()
        table = ""
        if rank in (0, SHARD_RANKS - 1):
            table = prof.key_averages().table(sort_by="cpu_time_total",
                                              row_limit=12)
        np.savez(f"{tmp}/rank{rank}.npz", traj=traj.cpu().numpy(),
                 ok=ok.cpu().numpy())
        dist.destroy_process_group()
        out_q.put((rank, {"launches": launches, "ms": secs * 1e3,
                          "profile": table}))
    except BaseException as e:  # reported to the parent, which fails
        out_q.put((rank, {"error": f"{type(e).__name__}: {e}"}))
        raise


def run_shard4(torch, seq, smi):
    """shard4: ``make_sharded_trajectory_fn`` on SHARD_RANKS ranks sharing
    the card (gloo, staged through the host) over frames 0-15, against
    ``make_relative_pose_fn`` + ``compose_trajectory`` in this process on
    the card. Returns launch counts summed over the ranks."""
    from openvo_tpu_torch import OdometerConfig
    from openvo_tpu_torch.parallel.sharding import (compose_trajectory,
                                                    make_relative_pose_fn)

    left, right = seq["left"][:SHARD_FRAMES], seq["right"][:SHARD_FRAMES]
    T_rel, ok_ref = make_relative_pose_fn(path_camera(seq),
                                          OdometerConfig())(left, right)
    traj_ref = compose_trajectory(T_rel).cpu().numpy()
    ok_ref = ok_ref.cpu().numpy()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(f"{tmp}/inputs.npz", left=left, right=right,
                 **{k: seq[k] for k in ("K", "dist", "R", "T")})
        ctx = multiprocessing.get_context("spawn")
        out_q = ctx.Queue()
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_shard_rank,
                             args=(r, tmp, out_q, DEVICE))
                 for r in range(SHARD_RANKS)]
        for pr in procs:
            pr.start()
        reports = {}
        try:
            deadline = time.perf_counter() + 600
            while len(reports) < SHARD_RANKS:
                rank, rep = out_q.get(
                    timeout=max(1.0, deadline - time.perf_counter()))
                reports[rank] = rep
                if "error" in rep:
                    break
        finally:
            for pr in procs:
                pr.join(timeout=60)
                if pr.is_alive():
                    pr.kill()
        errors = {r: v["error"] for r, v in reports.items() if "error" in v}
        if errors:
            raise AssertionError(f"shard4 ranks failed: {errors}")
        outs = [np.load(f"{tmp}/rank{r}.npz") for r in range(SHARD_RANKS)]
        outs = [(o["traj"], o["ok"]) for o in outs]
    log(f"[shard4] {SHARD_RANKS} ranks ran in "
        f"{time.perf_counter() - t0:.1f} s (start-up included); "
        f"{SHARD_FRAMES} frames, {SHARD_FRAMES // SHARD_RANKS} a rank: "
        f"one call (warm) "
        f"{[round(reports[r]['ms'], 3) for r in range(SHARD_RANKS)]} ms by "
        f"rank; tracked {int(ok_ref.sum())}/{SHARD_FRAMES} in one "
        f"process; {smi}")
    for r in (0, SHARD_RANKS - 1):
        log(f"[shard4] rank {r}, one call under torch.profiler:\n"
            f"{reports[r]['profile']}")
    gap = max(float(np.abs(t - traj_ref).max()) for t, _ in outs)
    same_ok = all(np.array_equal(o, ok_ref) for _, o in outs)
    log(f"[shard4] against one process: flags equal {same_ok}, trajectory "
        f"up to {gap} apart (limit {POSE_TOL}); launches by rank "
        f"{[reports[r]['launches'] for r in range(SHARD_RANKS)]}")
    if not same_ok or not gap <= POSE_TOL:
        raise AssertionError("shard4 differs from the one-process trajectory")
    for r in range(SHARD_RANKS):
        batched_path_kernels(reports[r]["launches"], f"shard4 rank {r}", 1)
    return {k: sum(reports[r]["launches"][k] for r in range(SHARD_RANKS))
            for k in reports[0]["launches"]}


def run_bench():
    """Phase 7: the port's benchmark, ``python3 -m
    openvo_tpu_torch.tools.bench --repeats BENCH_REPEATS``, its lines logged
    here. Fails unless it exits 0, every pass printed a result, the last
    line is the cumulative one, every pass ran captured, off-lat and on-lat
    track BENCH_TRACKED frames with an ATE within BENCH_ATE m, and off-tp
    and rig skip the same frames as off-lat, every repeat and (rig) every
    camera alike."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "openvo_tpu_torch.tools.bench", "--repeats",
           str(BENCH_REPEATS), "--budget", str(BENCH_BUDGET)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=BENCH_BUDGET + 120)
    for line in proc.stderr.splitlines() + proc.stdout.splitlines():
        log(f"[bench] {line}")
    log(f"[bench] {' '.join(cmd[1:])}: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    lines = proc.stdout.splitlines()
    results = {}
    for line in lines:
        if line.startswith("PASS_RESULT "):
            r = json.loads(line[len("PASS_RESULT "):])
            results[r["tag"]] = r
    if proc.returncode or set(results) != set(PASSES):
        raise AssertionError(f"bench: exit {proc.returncode}, results for "
                             f"{sorted(results)}")
    last = json.loads(lines[-1])
    if last.get("metric") != "stereo_vo_throughput_kitti_res":
        raise AssertionError(f"bench: the last line is not the cumulative "
                             f"one: {lines[-1]}")
    for tag in ("off-lat", "on-lat"):
        r = results[tag]
        if r["tracked"] < BENCH_TRACKED or not r["ate"] <= BENCH_ATE:
            raise AssertionError(f"bench {tag}: tracked {r['tracked']}, ATE "
                                 f"{r['ate']} m")
    eager = [tag for tag, r in results.items() if not r["captured"]]
    if eager:
        raise AssertionError(f"bench: passes {eager} ran eagerly")
    for tag, r in results.items():
        if (r["skipped"] != results["off-lat"]["skipped"] and tag in (
                "off-tp", "rig")) or not r["repeats_agree"] or not r.get(
                "cameras_agree", True):
            raise AssertionError(f"bench {tag}: skipped {r['skipped']} "
                                 f"(off-lat {results['off-lat']['skipped']})"
                                 f", repeats agree {r['repeats_agree']}")


def free(torch):
    """Return the device memory of a path's dropped odometer, graph and
    pool before the next path."""
    gc.collect()
    torch.cuda.empty_cache()


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
    lib_path = _build.build()   # once, before the tiled ranks load it
    _build.library()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    t0 = time.perf_counter()
    seq = get_sequence()   # rendered once, and cached for the bench's passes
    log(f"[render] {N_FRAMES} frames at {IMG_SIZE} in "
        f"{time.perf_counter() - t0:.1f} s")
    cam = StereoCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                       {"R": seq["R"], "T": seq["T"]}, SGBM, IMG_SIZE,
                       device=DEVICE)
    results = check_kernels(torch, seq, cam, OdometerConfig())
    checks = [r for r in results if r["path"] is None]
    checks += check_plain_stages(torch, seq, cam)
    checks.append(time_k4_library(torch, cam.device, smi))
    gc.collect()
    torch.cuda.empty_cache()
    launches, records = {}, {}
    for name in PATHS:
        launches[name], records[name] = run_path(torch, seq, name, smi)
        run_captured(torch, seq, name, smi, records[name])
        free(torch)
    for name, single in STREAMS.items():
        launches[name], eager = run_stream(torch, seq, smi, name,
                                           records[single])
        free(torch)
        run_captured_stream(torch, seq, smi, name, eager)
        free(torch)
    for name, single in RIGS.items():
        launches[name], eager = run_rig8(torch, seq, smi, name,
                                         records[single])
        free(torch)
        run_captured_rig(torch, seq, smi, name, eager)
        free(torch)
    for name in ("mono", "mono-own"):
        launches[name] = run_mono(torch, seq, name, smi)
    gc.collect()
    torch.cuda.empty_cache()
    launches["tiled4"] = run_tiled4(torch, seq, cam)
    launches["shard4"] = run_shard4(torch, seq, smi)
    gc.collect()
    torch.cuda.empty_cache()
    run_bench()
    kernels = [r for r in results if r["path"] is not None]
    for r in results:
        r["launches"] = launches[r["path"]][r["name"]] if r["path"] else 0
    for r in kernels:
        # a batched variant's launches are those of the batched paths
        batched = (r.get("frames", 1) > 1)
        r["launches_by_path"] = {n: c[r["name"]] for n, c in launches.items()
                                 if c.get(r["name"])
                                 and (n in BATCHED_PATHS) == batched}
    print(json.dumps({"kernels": kernels, "checks": checks}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
