"""ORB's kernels and their plain versions: the steered-BRIEF descriptor
kernel H4 (``csrc/orb.cu``), from a keypoint's pyramid level to its packed
descriptor, the pyramid kernel H6 (``csrc/resize.cu``), every level's
resize from level 0 in one launch, and the detection kernel H9
(``csrc/orb_corners.cu``), FAST, the NMS, the border and mask tests and
Harris over the whole stack in one launch (plain version
``ops/orb.corner_keys_plain``).

The plain version is the JAX package's descriptor stage
(``openvo_tpu/ops/orb.py:529-555``) in pieces: :func:`patch_windows_stack`
gathers each keypoint's raw 45x45 window, :func:`blur_windows` blurs it
with the 7 taps of ``gaussian_kernel_1d(7, 2.0)`` into the rounded 39x39
BRIEF window, :func:`brief_indices` rotates the rBRIEF pattern with
GET_VALUE rounding, and :func:`brief_sample_plain` compares and packs.
Each takes a batch of frames on a leading axis as well.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from openvo_tpu_torch import _build
from openvo_tpu_torch.ops._dispatch import (check_cuda_input,
                                            device_constant, device_of,
                                            stream_handle)
from openvo_tpu_torch.ops.hamming import pack_bits
from openvo_tpu_torch.ops.image import (fma, gaussian_kernel_1d,
                                        resize_bilinear, resize_taps)

BRIEF_WIN = 19   # rotated +/-13 pattern points stay < 19 px from the centre
BLUR_TAPS = tuple(float(v) for v in gaussian_kernel_1d(7, 2.0))
RAW_WIN = BRIEF_WIN + len(BLUR_TAPS) // 2   # raw window radius, 22


def _cv2_orb_pattern():
    from openvo_tpu_torch.ops.orb_pattern import CV2_ORB_PATTERN

    return CV2_ORB_PATTERN


def brief_pattern(device) -> torch.Tensor:
    """OpenCV's ORB rBRIEF 256-pair test pattern as float32 (256, 4)
    (px, py, qx, qy) on ``device``, built once per device."""
    return device_constant(_cv2_orb_pattern, device)


def patch_windows_stack(stack, levels, xy, r: int):
    """(K, 2r+1, 2r+1) windows centred at ``xy`` on each keypoint's level of
    the (nl, H, W) stack. Starts are clamped into the stack like
    ``lax.dynamic_slice`` (padding rows at xy = 0 read level 0's corner).
    A batch, (B, nl, H, W) stacks with (B, K) levels and (B, K, 2) xy,
    gives (B, K, 2r+1, 2r+1): each frame's keypoints read its own stack."""
    nl, H, W = stack.shape[-3:]
    size = 2 * r + 1
    ar = torch.arange(size, device=stack.device)
    y0 = (xy[..., 1].to(torch.int64) - r).clamp(0, H - size)
    x0 = (xy[..., 0].to(torch.int64) - r).clamp(0, W - size)
    lv = levels.to(torch.int64).clamp(0, nl - 1)
    if stack.ndim == 4:   # the frame's levels in the (B * nl) levels
        lv = lv + nl * torch.arange(stack.shape[0],
                                    device=stack.device)[:, None]
    rows = (y0[..., None] + ar)[..., :, None]
    cols = (x0[..., None] + ar)[..., None, :]
    return stack.reshape(-1, H, W)[lv[..., None, None], rows, cols]


def blur_windows(wins_raw):
    """(K, 39, 39) BRIEF windows: the valid part of the separable 7-tap blur
    of (K, 45, 45) raw windows, rows first, rounded half to even like ORB's
    uint8 working image. XLA's order: fma(k0, t0, k1 * t1), then
    fma(k_i, t_i, acc)."""
    kb = BLUR_TAPS
    size = 2 * BRIEF_WIN + 1

    def blur(taps):
        acc = fma(kb[0], taps(0), kb[1] * taps(1))
        for i in range(2, len(kb)):
            acc = fma(kb[i], taps(i), acc)
        return acc

    h_pass = blur(lambda i: wins_raw[..., :, i:i + size])
    return torch.round(blur(lambda i: h_pass[..., i:i + size, :]))


def brief_indices(cos_a, sin_a):
    """(K, 256) int32 flat indices into the (39, 39) window of the rotated
    rBRIEF p and q points, with OpenCV's GET_VALUE rounding:
    col = round(x cos - y sin), row = round(x sin + y cos)."""
    pat = brief_pattern(cos_a.device)
    px, py, qx, qy = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]
    rw = BRIEF_WIN
    size = 2 * rw + 1
    ca, sa = cos_a[..., None], sin_a[..., None]

    def local_idx(x, y):
        col = rw + torch.round(fma(x, ca, -(y * sa))).to(torch.int32)
        row = rw + torch.round(fma(x, sa, y * ca)).to(torch.int32)
        return (row * size + col).contiguous()

    return local_idx(px, py), local_idx(qx, qy)


def brief_sample_plain(wins, idx_p, idx_q, valid):
    """The sampling half of H4 (K5's gathers, then compare and pack): bit j
    of keypoint k is wins[k, p] < wins[k, q] at the flat window indices
    p = idx_p[k, j], q = idx_q[k, j]; zero rows for invalid keypoints;
    packed to (K, N/8) uint8."""
    tp = torch.gather(wins, -1, idx_p.to(torch.int64))
    tq = torch.gather(wins, -1, idx_q.to(torch.int64))
    return pack_bits((tp < tq) & valid[..., None])


def brief_describe_plain(stack, octave, xy_lvl, cos_a, sin_a, valid):
    """Plain H4: raw windows, blur, rotated pattern, compare and pack."""
    wins = blur_windows(patch_windows_stack(stack, octave, xy_lvl, RAW_WIN))
    idx_p, idx_q = brief_indices(cos_a, sin_a)
    return brief_sample_plain(wins.flatten(-2), idx_p, idx_q, valid)


def brief_describe(stack, octave, xy_lvl, cos_a, sin_a, valid):
    """H4, replacing ``orb_pallas.brief_sample_t`` (K5) and the window
    gather, blur and rotation around it: stack (nl, H, W) float32 pyramid,
    octave (K,) int64 levels, xy_lvl (K, 2) int64 level coordinates,
    cos_a/sin_a (K,) float32 cosine and sine of one angle per keypoint
    (torch.cos/torch.sin), valid (K,) bool -> (K, 32) uint8 descriptors.

    One block per keypoint reads its raw window from the stack into shared
    memory, blurs it there and samples the 256 pairs (see ``csrc/orb.cu``):
    one launch, bound by the windows' bytes (4.1 MB at K = 512).

    A batch, (B, nl, H, W) stacks with (B, K) keypoint rows (and (B, K, 2)
    xy_lvl), gives (B, K, 32) from one launch of B * K blocks."""
    dev = device_of(stack, octave, xy_lvl, cos_a, sin_a, valid)
    if dev.type == "cpu":
        return brief_describe_plain(stack, octave, xy_lvl, cos_a, sin_a,
                                    valid)
    if stack.ndim not in (3, 4):
        raise ValueError(f"stack: {stack.ndim} axes, expected (nl, H, W) or "
                         f"(B, nl, H, W)")
    lead = tuple(stack.shape[:-3])
    nl, H, W = stack.shape[-3:]
    K = octave.shape[-1]
    check_cuda_input(stack, torch.float32, lead + (nl, H, W), "stack")
    check_cuda_input(octave, torch.int64, lead + (K,), "octave")
    check_cuda_input(xy_lvl, torch.int64, lead + (K, 2), "xy_lvl")
    check_cuda_input(cos_a, torch.float32, lead + (K,), "cos_a")
    check_cuda_input(sin_a, torch.float32, lead + (K,), "sin_a")
    check_cuda_input(valid, torch.bool, lead + (K,), "valid")
    size = 2 * RAW_WIN + 1
    if H < size or W < size:
        raise ValueError(f"stack: levels of {H}x{W}, smaller than the "
                         f"{size}x{size} window")
    out = torch.empty(lead + (K, 32), dtype=torch.uint8, device=dev)
    frames = lead[0] if lead else 1
    if K == 0 or frames == 0:
        return out
    lib = _build.library()
    pattern = brief_pattern(dev)
    taps = (ctypes.c_float * len(BLUR_TAPS))(*BLUR_TAPS)
    err = lib.ovo_brief_describe(
        stack.data_ptr(), nl, H, W, octave.data_ptr(), xy_lvl.data_ptr(),
        cos_a.data_ptr(), sin_a.data_ptr(), valid.data_ptr(),
        pattern.data_ptr(), taps, out.data_ptr(), K, frames,
        stream_handle(dev))
    brief_describe.launches += 1
    _build.check_launch(err, "brief_describe")
    return out


brief_describe.launches = 0


def resize_levels_plain(img, dims):
    """ORB's pyramid stack (..., nl, H, W) from level-0 images (..., H, W):
    level 0 the image, level l its :func:`resize_bilinear` to ``dims[l]``
    (h, w), cut to H x W, zero beyond the level."""
    H, W = img.shape[-2:]
    img = img.to(torch.float32)
    stack = img.new_zeros(img.shape[:-2] + (len(dims), H, W))
    stack[..., 0, :, :] = img
    for level, (h, w) in enumerate(dims[1:], 1):
        hh, ww = min(h, H), min(w, W)
        stack[..., level, :hh, :ww] = resize_bilinear(img, h, w)[
            ..., :hh, :ww]
    return stack


# A warp of H6 or H9 writes one span (csrc/spans.cuh): at most this many
# floats, or one whole run of a row where that is longer.
SPAN_FLOATS = 2048


def canvas_spans(H: int, W: int, keep, copy=()):
    """The spans (int32 (n, 4): {dst, n, rows, src}, csrc/spans.cuh) of a
    frame's (nl, H, W) stack that H6 and H9 write outside their tiles: of
    each level l, its (H, W) plane less the rectangle ``keep[l]`` =
    (y0, y1, x0, x1) (none where it is empty), in runs of at most
    SPAN_FLOATS; of the levels in ``copy``, the whole plane, copied from
    the same place of the frame's (H, W) input (src >= 0). Offsets count
    floats from the frame's start."""
    if len(keep) * H * W >= 2 ** 31:
        raise ValueError(f"a stack of {len(keep)}x{H}x{W} is too large for "
                         f"32-bit offsets")
    out = []

    def flat(base, a, b, src):
        for s in range(a, b, SPAN_FLOATS):
            out.append((base + s, min(SPAN_FLOATS, b - s), 1,
                        s if src else -1))

    for level, (y0, y1, x0, x1) in enumerate(keep):
        base = level * H * W
        if level in copy or y0 >= y1 or x0 >= x1:
            flat(base, 0, H * W, level in copy)
            continue
        flat(base, 0, y0 * W + x0, False)
        n = W - (x1 - x0)   # from a row's x1 to the next row's x0
        if n > 0:
            step = max(1, SPAN_FLOATS // n)
            out += [(base + y * W + x1, n, min(step, y1 - 1 - y), -1)
                    for y in range(y0, y1 - 1, step)]
        flat(base, (y1 - 1) * W + x1, H * W, False)
    return np.asarray(out, np.int32).reshape(-1, 4)


# H6's tiles: at most 16 output rows by 64 columns, and the most image
# floats and mid values a tile holds in shared memory (csrc/resize.cu's
# kTileRows, kTileCols, kInFloats, kMidFloats)
RESIZE_TILE = (16, 64)
RESIZE_IN = 4096
RESIZE_MID = 2048


def _reach(first, count, a, b):
    """[lo, hi): the inputs that outputs [a, b) of a band of taps read
    (``resize_taps``' first and count); (0, 0) where they read none."""
    on = count[a:b] > 0
    if not on.any():
        return 0, 0
    return (int(first[a:b][on].min()),
            int((first[a:b] + count[a:b])[on].max()))


def _resize_tiles(H, W, dims, rows, cols):
    """H6's tiles of a frame: {level, i0, i1, j0, j1, c_lo, c_hi, r_lo,
    r_hi, row0, col0} (csrc/resize.cu), int32 (n, 11); a level's tiles are
    made narrower (then shorter) until each one's image rows and columns
    fit RESIZE_IN and its mid values RESIZE_MID."""
    tiles = []
    row0 = col0 = 0
    for level, ((h, w), (rf, rc, _), (cf, cc, _)) in enumerate(
            zip(dims[1:], rows, cols), 1):
        hh, ww = min(h, H), min(w, W)

        def fits(th, tw):
            for i in range(0, hh, th):
                r_lo, r_hi = _reach(rf, rc, i, i + th)
                for j in range(0, ww, tw):
                    c_lo, c_hi = _reach(cf, cc, j, j + tw)
                    if (min(th, hh - i) * (c_hi - c_lo) > RESIZE_MID
                            or (r_hi - r_lo) * (c_hi - c_lo) > RESIZE_IN):
                        return False
            return True

        th, tw = min(RESIZE_TILE[0], hh), RESIZE_TILE[1]
        while not fits(th, tw):
            if tw > 1:
                tw //= 2
            elif th > 1:
                th //= 2
            else:
                raise ValueError(f"level {level} ({h}x{w}): one output's "
                                 f"taps exceed H6's shared memory")
        for i0 in range(0, hh, th):
            i1 = min(i0 + th, hh)
            for j0 in range(0, ww, tw):
                j1 = min(j0 + tw, ww)
                tiles.append((level, i0, i1, j0, j1, *_reach(cf, cc, j0, j1),
                              *_reach(rf, rc, i0, i1), row0, col0))
        row0 += h
        col0 += w
    return np.asarray(tiles, np.int32).reshape(-1, 11)


@functools.lru_cache(maxsize=16)
def level_tables(H: int, W: int, dims: tuple, device):
    """H6's tables on ``device``, built and uploaded once per frame size
    and level sizes: every level after the first, its rows' and then its
    columns' :func:`resize_taps`, concatenated and padded to one tap
    count; the tap count; the tiles (:func:`_resize_tiles`); the spans of
    the stack that no tile writes (level 0, copied from the image, and the
    zeros beyond each level, :func:`canvas_spans`)."""
    rows = [resize_taps(H, h) for h, _ in dims[1:]]
    cols = [resize_taps(W, w) for _, w in dims[1:]]
    taps = max((t[2].shape[1] for t in rows + cols), default=1)

    def cat(parts):
        if not parts:
            return tuple(torch.zeros(1, dtype=dt, device=device)
                         for dt in (torch.int32, torch.int32, torch.float32))
        first = np.concatenate([p[0] for p in parts])
        count = np.concatenate([p[1] for p in parts])
        w = np.concatenate([np.pad(p[2], ((0, 0), (0, taps - p[2].shape[1])))
                            for p in parts])
        return tuple(torch.from_numpy(a).to(device) for a in (first, count,
                                                              w))

    keep = [(0, 0, 0, 0)] + [(0, min(h, H), 0, min(w, W))
                             for h, w in dims[1:]]
    tiles = _resize_tiles(H, W, dims, rows, cols)
    spans = canvas_spans(H, W, keep, copy=(0,))
    return (cat(rows), cat(cols), taps,
            *(torch.from_numpy(a).to(device) for a in (tiles, spans)))


def resize_levels(img, dims):
    """H6, replacing the two contractions a level of ``jax.image.resize``
    inside JAX's ORB (``openvo_tpu/ops/image.py:82-85``, XLA): the pyramid
    stack (nl, H, W) float32 of a (H, W) float32 image, level l its
    antialiased linear resize to ``dims[l]`` = (h, w), cut to H x W and
    zero beyond; each output pixel is :func:`resize_levels_plain`'s two
    chains of multiply-adds in its order, so the bits are the plain
    version's. One launch writes the whole stack: the levels' tiles, level
    0's copy and the zeros (see ``csrc/resize.cu``).

    A batch, (B, H, W) images, gives (B, nl, H, W) from the same launch."""
    dev = img.device
    if dev.type == "cpu":
        return resize_levels_plain(img, dims)
    if img.ndim not in (2, 3):
        raise ValueError(f"img: {img.ndim} axes, expected (H, W) or "
                         f"(B, H, W)")
    lead = tuple(img.shape[:-2])
    H, W = img.shape[-2:]
    check_cuda_input(img, torch.float32, lead + (H, W), "img")
    dims = tuple((int(h), int(w)) for h, w in dims)
    stack = torch.empty(lead + (len(dims), H, W), dtype=torch.float32,
                        device=dev)
    frames = lead[0] if lead else 1
    if frames == 0:
        return stack
    (r0, rn, rw), (c0, cn, cw), taps, tiles, spans = level_tables(
        H, W, dims, dev)
    err = _build.library().ovo_resize_levels(
        img.data_ptr(), H, W, len(dims), tiles.data_ptr(), tiles.shape[0],
        spans.data_ptr(), spans.shape[0], r0.data_ptr(), rn.data_ptr(),
        rw.data_ptr(), c0.data_ptr(), cn.data_ptr(), cw.data_ptr(), taps,
        stack.data_ptr(), frames, stream_handle(dev))
    resize_levels.launches += 1
    _build.check_launch(err, "resize_levels")
    return stack


resize_levels.launches = 0


def fast_pretest(img, threshold: float):
    """H9's pretest of FAST (``csrc/orb_corners.cu``) on (..., H, W)
    images: (bright, dark), bool, where two adjacent ones of the four
    cardinal circle pixels (indices 0, 4, 8, 12 of ``orb.FAST_CIRCLE``,
    read with FAST's replicate padding) both exceed the pixel by more than
    ``threshold`` (bright), or both fall short of it by more (dark). Every
    arc of 9 holds two adjacent cardinals, so where a polarity fails its
    arc score is <= threshold, and where both fail, FAST's score is."""
    from openvo_tpu_torch.ops import orb   # orb imports this module

    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    pad = F.pad(img.reshape((-1, 1, H, W)), (3, 3, 3, 3),
                mode="replicate").reshape(lead + (H + 6, W + 6))
    card = [pad[..., 3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
            for dx, dy in orb.FAST_CIRCLE[::4]]

    def adjacent(f):
        return (f[0] & f[1]) | (f[1] & f[2]) | (f[2] & f[3]) | (f[3] & f[0])

    return (adjacent([n - img > threshold for n in card]),
            adjacent([img - n > threshold for n in card]))


# H9's tiles: 32 rows by 64 columns (csrc/orb_corners.cu's kTileH, kTileW)
CORNER_TILE = (32, 64)


@functools.lru_cache(maxsize=16)
def corner_tables(H: int, W: int, dims: tuple, edge: int, device):
    """H9's tables of a frame on ``device``, int32, built and uploaded once
    per frame size, level sizes and edge: the tiles {level, y0, y1, x0,
    x1} (n, 5) that cover each level's border box (the pixels ORB's border
    test keeps, edge <= y < h_l - edge and the same in x, cut to the
    canvas) from its top-left corner, CORNER_TILE each and ragged at the
    box's far edges, and the spans of the canvas outside the boxes
    (:func:`canvas_spans`)."""
    th, tw = CORNER_TILE
    tiles, keep = [], []
    for level, (h, w) in enumerate(dims):
        y0, y1 = max(edge, 0), min(h - edge, H)
        x0, x1 = max(edge, 0), min(w - edge, W)
        keep.append((y0, y1, x0, x1))
        tiles += [(level, ty, min(ty + th, y1), tx, min(tx + tw, x1))
                  for ty in range(y0, y1, th) if x0 < x1
                  for tx in range(x0, x1, tw)]
    return tuple(torch.from_numpy(a).to(device) for a in (
        np.asarray(tiles, np.int32).reshape(-1, 5), canvas_spans(H, W, keep)))


def corner_keys(stack, mask, dims, edge: int, threshold: float,
                with_score: bool = False):
    """H9, replacing the per-pixel stages that XLA fuses inside JAX's ORB
    (``openvo_tpu/ops/orb.py:434-445``: ``fast_score``, ``_nms3x3``, the
    border and mask tests, ``harris_response``): over the (nl, H, W)
    float32 pyramid stack of levels ``dims`` (h_l, w_l), key = the Harris
    response at each corner and -inf elsewhere, and with ``with_score``
    fkey = the FAST score at each corner (else None), bit for bit those of
    ``orb.corner_keys_plain``. ``mask``: None or the (H, W) bool level-0
    mask; ``edge``: the border; ``threshold``: FAST's. One launch for
    every level: tiles of the levels' border boxes (FAST's arcs only where
    :func:`fast_pretest` passes, Harris only at corners) and -inf beyond
    them (see ``csrc/orb_corners.cu``).

    A batch, (B, nl, H, W) stacks with (B, H, W) masks, gives (B, nl, H,
    W) keys from the same launch."""
    from openvo_tpu_torch.ops import orb   # orb imports this module

    dev = stack.device if mask is None else device_of(stack, mask)
    if dev.type == "cpu":
        return orb.corner_keys_plain(stack, mask, dims, edge, threshold,
                                     with_score)
    if stack.ndim not in (3, 4):
        raise ValueError(f"stack: {stack.ndim} axes, expected (nl, H, W) or "
                         f"(B, nl, H, W)")
    lead = tuple(stack.shape[:-3])
    nl, H, W = stack.shape[-3:]
    check_cuda_input(stack, torch.float32, lead + (nl, H, W), "stack")
    dims = tuple((int(h), int(w)) for h, w in dims)
    if len(dims) != nl:
        raise ValueError(f"dims: {len(dims)} levels, the stack {nl}")
    key = torch.empty_like(stack)
    fkey = torch.empty_like(stack) if with_score else None
    frames = lead[0] if lead else 1
    if frames == 0:
        return key, fkey
    rows = cols = None
    if mask is not None:
        check_cuda_input(mask, torch.bool, lead + (H, W), "mask")
        rows = device_constant(orb.mask_level_table, dev, torch.int32, H,
                               tuple(h for h, _ in dims))
        cols = device_constant(orb.mask_level_table, dev, torch.int32, W,
                               tuple(w for _, w in dims))
    tiles, spans = corner_tables(H, W, dims, int(edge), dev)
    err = _build.library().ovo_corner_keys(
        stack.data_ptr(), H, W, nl, tiles.data_ptr(), tiles.shape[0],
        spans.data_ptr(), spans.shape[0],
        *(None if t is None else t.data_ptr() for t in (mask, rows, cols)),
        float(threshold), key.data_ptr(),
        None if fkey is None else fkey.data_ptr(), frames,
        stream_handle(dev))
    corner_keys.launches += 1
    _build.check_launch(err, "corner_keys")
    return key, fkey


corner_keys.launches = 0

KERNELS = (brief_describe, resize_levels, corner_keys)
