"""ORB of the plain reference: pyramid, FAST, NMS, Harris, per-level top-k,
intensity-centroid angle and steered BRIEF, ``cv2.ORB`` semantics with
keypoints ranked by Harris response.

Frozen copy of the plain versions in ``openvo_tpu_torch/ops/orb.py`` and
``ops/orb_cuda.py`` of the commit that defined the benchmark: plain PyTorch, no kernel, no import of
the program, so that a later change to the program cannot move it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from vobench.reference.image import (box_filter, fma, gaussian_kernel_1d,
                                     resize_bilinear, sobel_xy)
from vobench.reference.match import pack_bits
from vobench.reference.orb_pattern import CV2_ORB_PATTERN
from vobench.reference.util import device_constant


BRIEF_WIN = 19   # rotated +/-13 pattern points stay < 19 px from the centre


BLUR_TAPS = tuple(float(v) for v in gaussian_kernel_1d(7, 2.0))


RAW_WIN = BRIEF_WIN + len(BLUR_TAPS) // 2   # raw window radius, 22


def brief_pattern(device) -> torch.Tensor:
    """OpenCV's ORB rBRIEF 256-pair test pattern as float32 (256, 4)
    (px, py, qx, qy) on ``device``, built once per device."""
    return device_constant(lambda: CV2_ORB_PATTERN, device)


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


HALF_PATCH = 15  # intensity-centroid circle radius (OpenCV halfPatchSize)


FAST_CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)


@functools.lru_cache(maxsize=None)
def _cv2_umax(radius: int = HALF_PATCH):
    """OpenCV ORB's discretized circle bounds umax[v] (cvRound circle with
    the symmetry fix-up of the ORB initializer)."""
    r = radius
    vmax = int(np.floor(r * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(r * np.sqrt(2.0) / 2))
    umax = np.zeros(r + 2, np.int64)
    for v in range(vmax + 1):
        umax[v] = int(np.rint(np.sqrt(float(r * r - v * v))))
    v0 = 0
    for v in range(r, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


@functools.lru_cache(maxsize=None)
def centroid_weights(radius: int = HALF_PATCH):
    """(u, v) coordinate weight grids over cv2 ORB's circular patch."""
    r = radius
    umax = _cv2_umax(r)
    v, u = np.mgrid[-r:r + 1, -r:r + 1]
    circ = np.abs(u) <= umax[np.abs(v)]
    return (u * circ).astype(np.float32), (v * circ).astype(np.float32), circ


def _centroid_uv():
    """(2, 31 * 31): the flattened (u, v) centroid weights."""
    uw, vw, _ = centroid_weights()
    return np.stack([uw.reshape(-1), vw.reshape(-1)])


def features_per_level(nfeatures: int, nlevels: int, scale_factor: float):
    """OpenCV ORB's geometric per-level feature budget."""
    factor = 1.0 / scale_factor
    ndesired = nfeatures * (1 - factor) / (1 - factor**nlevels)
    counts = []
    total = 0
    for _ in range(nlevels - 1):
        c = int(round(ndesired))
        counts.append(c)
        total += c
        ndesired *= factor
    counts.append(max(nfeatures - total, 0))
    return counts


def fast_score(img, threshold: float):
    """FAST-9/16 score of (..., H, W) images: max over the 16 arc starts of
    the min margin over 9 contiguous circle pixels (bright and dark).
    Returns (score, corner = score > threshold)."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    pad = F.pad(img.reshape((-1, 1, H, W)), (3, 3, 3, 3),
                mode="replicate").reshape(lead + (H + 6, W + 6))
    neigh = [pad[..., 3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
             for dx, dy in FAST_CIRCLE]

    def arc_score(m):
        m2 = [torch.minimum(m[k], m[(k + 1) % 16]) for k in range(16)]
        m4 = [torch.minimum(m2[k], m2[(k + 2) % 16]) for k in range(16)]
        m8 = [torch.minimum(m4[k], m4[(k + 4) % 16]) for k in range(16)]
        m9 = [torch.minimum(m8[k], m[(k + 8) % 16]) for k in range(16)]
        out = m9[0]
        for k in range(1, 16):
            out = torch.maximum(out, m9[k])
        return out

    bright = [n - img for n in neigh]
    dark = [img - n for n in neigh]
    score = torch.maximum(arc_score(bright), arc_score(dark))
    return score, score > threshold


def _nms3x3(score):
    """3x3 non-max suppression of (..., H, W): keep pixels equal to their
    neighbourhood max (-inf outside the image)."""
    H, W = score.shape[-2:]
    pad = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    mx = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            mx = torch.maximum(mx, pad[..., 1 + dy:1 + dy + H,
                                       1 + dx:1 + dx + W])
    return score >= mx


def harris_response(img, block_size: int = 7, k: float = 0.04):
    """Harris corner response of (..., H, W) images (raw, unscaled):
    det - k tr^2 with XLA's two fused multiply-adds."""
    dx, dy = sobel_xy(img)
    sxx = box_filter(dx * dx, block_size)
    syy = box_filter(dy * dy, block_size)
    sxy = box_filter(dx * dy, block_size)
    det = fma(sxx, syy, -(sxy * sxy))
    tr = sxx + syy
    ktr = device_constant(k, img.device) * tr
    return fma(-ktr, tr, det)


def _topk_flat(flat, k: int):
    """Top-k along the last axis, ties to the lower index (``lax.top_k``):
    a stable sort, so a row of a batch gets the 1-D call's indices."""
    vals, idx = torch.sort(flat, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def orientations(det):
    """Intensity-centroid angle (radians) of each keypoint of
    :func:`detect`, from its (31, 31) window; 0 for invalid rows.

    The JAX package cuts this window out of the (45, 45) descriptor window.
    For a valid keypoint the two agree, since :func:`detect` keeps every
    keypoint >= 22 px inside the stack, so neither window's start is
    clamped; an invalid row's angle is 0 either way. A batch's windows are
    gathered at once; the two weighted sums (matrix-vector products) run
    frame by frame, so that each frame's angle has the one-frame call's
    bits."""
    wins = patch_windows_stack(det["stack"], det["octave"], det["xy_lvl"],
                               HALF_PATCH)
    uw, vw = device_constant(_centroid_uv, wins.device)
    flat = wins.flatten(-2)

    def angle(f):
        return torch.atan2(f @ vw, f @ uw)

    ang = angle(flat) if flat.ndim == 2 else torch.stack(
        [angle(f) for f in flat])
    return torch.where(det["valid"], ang, 0.0)


def _level_dims(H: int, W: int, params: ORBParams):
    b = params.edge_threshold
    dims = []
    for level in range(params.nlevels):
        scale = params.scale_factor**level
        dims.append((max(int(round(H / scale)), 2 * b + 3),
                     max(int(round(W / scale)), 2 * b + 3)))
    return dims


def _mask_level_index(n: int, n_l: int):
    """Nearest-neighbour rows (or columns) of the level-0 mask for a level
    of n_l rows (columns), float32 products rounded half-to-even like the
    JAX package."""
    f32 = np.float32
    return np.clip(np.round(np.arange(n_l, dtype=f32) * f32(n / n_l)),
                   0, n - 1).astype(np.int64)


def corner_keys_plain(stack, mask, dims, edge: int, threshold: float,
                      with_score: bool = False, low: bool = False):
    """ORB's per-pixel detection stages over a (..., nl, H, W) pyramid
    stack (the plain version of H9, ``orb_cuda.corner_keys``): FAST's
    score and corner test, the 3x3 NMS, the border test (``edge`` <= x <
    w_l - ``edge``, the same in y, level l of ``dims[l]`` = (h_l, w_l)),
    the mask test (``mask``: None or the (..., H, W) bool level-0 mask,
    read at level l nearest-neighbour, false past min(h_l, H) x
    min(w_l, W)) and the Harris response. Returns (key, fkey): key =
    the response where a pixel is a corner, -inf elsewhere; with
    ``with_score`` fkey = the FAST score there (else None)."""
    nl, H, W = stack.shape[-3:]
    dev = stack.device
    score, corner = fast_score(stack, threshold)
    corner = corner & _nms3x3(score)
    hl = device_constant(tuple(h for h, _ in dims), dev,
                         torch.int64)[:, None, None]
    wl = device_constant(tuple(w for _, w in dims), dev,
                         torch.int64)[:, None, None]
    ys = torch.arange(H, device=dev)[None, :, None]
    xs = torch.arange(W, device=dev)[None, None, :]
    corner &= ((xs >= edge) & (xs < wl - edge) & (ys >= edge)
               & (ys < hl - edge))
    if mask is not None:
        mstack = torch.zeros(mask.shape[:-2] + (nl, H, W), dtype=torch.bool,
                             device=dev)
        mstack[..., 0, :, :] = mask
        for level in range(1, nl):
            h_l, w_l = dims[level]
            hh, ww = min(h_l, H), min(w_l, W)
            yy = device_constant(_mask_level_index, dev, torch.int64, H, h_l)
            xx = device_constant(_mask_level_index, dev, torch.int64, W, w_l)
            m_l = mask.index_select(-2, yy).index_select(-1, xx)
            mstack[..., level, :hh, :ww] = m_l[..., :hh, :ww]
        corner &= mstack
    resp = harris_response(stack)
    if low:   # the control: the response held in bfloat16
        resp = resp.to(torch.bfloat16).to(torch.float32)
    neg_inf = float("-inf")
    key = torch.where(corner, resp, neg_inf)
    return key, torch.where(corner, score, neg_inf) if with_score else None


def detect(img, mask, params: ORBParams):
    """Keypoint detection half of ORB on a (H, W) grayscale image.

    ``mask``: optional (H, W) detection mask (nonzero = allowed). Returns
    a dict: stack (nl, H, W) pyramid, and with K = params.max_keypoints
    rows, valid first: xy_lvl (K, 2) int64 level coords, octave (K,),
    response (K,) Harris response, valid (K,) bool.

    A batch, (B, H, W) images (and masks), gives every output a leading
    frame axis, each frame's bit for bit: the pyramid (H6,
    ``orb_cuda.resize_levels``, in its fixed order), the per-pixel stages
    (H9, ``orb_cuda.corner_keys``), the per-level top-k and the
    compaction run once for the batch (sorts along the last axis,
    stable).
    """
    H, W = img.shape[-2:]
    lead = tuple(img.shape[:-2])
    dev = img.device
    imgf = img.to(torch.float32)
    nl = params.nlevels
    b = params.edge_threshold
    if b < RAW_WIN:
        raise ValueError(
            f"edge_threshold={b} < {RAW_WIN}: the descriptor kernel needs"
            f" keypoints >= {RAW_WIN} px inside their level")
    budgets = features_per_level(params.nfeatures, nl, params.scale_factor)
    dims = _level_dims(H, W, params)
    k_eff = [max(min(budgets[lv], dims[lv][0] * dims[lv][1]), 1)
             for lv in range(nl)]
    P = max(k_eff)

    # --- pyramid stack (H6), then the per-pixel stages over it (H9):
    # key = the Harris response at corners, fkey = the FAST score there,
    # -inf elsewhere ---
    stack = resize_levels_plain(imgf, dims)
    m0 = None if mask is None else (mask > 0).contiguous()
    key, fkey = corner_keys_plain(stack, m0, dims, b,
                                     float(params.fast_threshold),
                                     params.cv2_ranking,
                                     getattr(params, "low", False))

    # --- per-level top-k on each level's own (h_l, w_l) canvas ---
    xy_list, val_list = [], []
    for lv in range(nl):
        h_l, w_l = dims[lv]
        key_l = key[..., lv, :h_l, :w_l].reshape(lead + (-1,))
        if not params.cv2_ranking:
            kk = k_eff[lv]
            tv, ti = _topk_flat(key_l, kk)
        else:
            # the best 2k by FAST score (cv2's pre-Harris retainBest), then
            # the best of those by Harris response: key holds it at every
            # corner, and key and fkey are -inf at the same pixels, so a
            # winner that is no corner is -inf in both
            k2 = min(2 * k_eff[lv], h_l * w_l)
            fkey_l = fkey[..., lv, :h_l, :w_l].reshape(lead + (-1,))
            _, fi = _topk_flat(fkey_l, k2)
            resp_at = key_l.gather(-1, fi)
            kk = min(P, k2)
            tv, sel = _topk_flat(resp_at, kk)
            ti = fi.gather(-1, sel)
        if kk < P:
            tv = F.pad(tv, (0, P - kk), value=float("-inf"))
            ti = F.pad(ti, (0, P - kk))
        xy_list.append(torch.stack([ti % w_l, ti // w_l], dim=-1))
        val_list.append(tv)
    top_vals = torch.stack(val_list, dim=-2)         # (..., nl, P)
    xy2 = torch.stack(xy_list, dim=-3)               # (..., nl, P, 2)
    rank = torch.arange(P, device=dev)[None, :]
    budget = device_constant(tuple(k_eff), dev, torch.int64)[:, None]
    valid2 = torch.isfinite(top_vals) & (rank < budget)

    # --- compact to the fixed capacity: valid rows first, level-major rank
    # order (or best response first when more than K can be valid) ---
    K = params.max_keypoints
    n = nl * P
    lv_flat = torch.arange(nl, device=dev).repeat_interleave(P).expand(
        lead + (n,))
    xy_flat = xy2.reshape(lead + (n, 2))
    resp_flat = top_vals.reshape(lead + (n,))
    valid_flat = valid2.reshape(lead + (n,))
    inf = float("inf")
    if sum(k_eff) > K:
        order_key = torch.where(valid_flat, -resp_flat, inf)
    else:
        order_key = torch.where(
            valid_flat, torch.arange(n, dtype=torch.float32, device=dev), inf)
    perm = torch.sort(order_key, stable=True).indices[..., :K]
    ax = len(lead)   # the row axis

    def compact(a, pad_val=0):
        idx = perm.reshape(perm.shape + (1,) * (a.ndim - perm.ndim))
        a = a.gather(ax, idx.expand(perm.shape + a.shape[ax + 1:]))
        if n < K:
            padding = torch.full(lead + (K - n,) + a.shape[ax + 1:], pad_val,
                                 dtype=a.dtype, device=dev)
            a = torch.cat([a, padding], dim=ax)
        return a

    return {"stack": stack, "xy_lvl": compact(xy_flat),
            "octave": compact(lv_flat),
            "response": compact(resp_flat, float("-inf")),
            "valid": compact(valid_flat, False)}


def detect_and_compute(img, mask, params: ORBParams):
    """Full ORB on a (H, W) grayscale image (any dtype, on any device).

    ``mask``: optional (H, W) detection mask (nonzero = allowed).
    Returns a dict of fixed-capacity tensors (K = params.max_keypoints):
    xy (K, 2) float32 level-0 coords, response (K,), angle (K,),
    octave (K,) int64, size (K,), desc (K, 32) uint8, valid (K,) bool.
    A (B, H, W) batch gives each a leading frame axis (:func:`detect`),
    with one launch of H4 for the batch.
    """
    det = detect(img, mask, params)
    ang = orientations(det)
    valid, octv = det["valid"], det["octave"]
    desc = brief_describe_plain(det["stack"], octv, det["xy_lvl"],
                                   torch.cos(ang), torch.sin(ang), valid)
    scale_tab = device_constant(tuple(params.scale_factor**lv for lv in
                                      range(params.nlevels)), img.device)
    sf = device_constant(params.scale_factor, img.device)
    xy = det["xy_lvl"].to(torch.float32) * scale_tab[octv][..., None]
    size = torch.where(valid, 31.0 * torch.pow(sf, octv.to(torch.float32)),
                       0.0)
    return {
        "xy": xy,
        "response": det["response"],
        "angle": ang,
        "octave": octv,
        "size": size,
        "desc": desc,
        "valid": valid,
    }

