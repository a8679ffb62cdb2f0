"""SGBM of the plain reference: int16 disparity on the x16 grid from a
rectified pair, ``cv2.StereoSGBM`` semantics (x-Sobel prefilter,
Birchfield-Tomasi cost, box sum, 5-path aggregation, WTA with uniqueness,
subpixel, left-right check, speckle filter).

Frozen copy of the plain versions in ``openvo_tpu_torch/ops/sgbm.py`` and
``ops/sgbm_cuda.py`` of the commit that defined the benchmark: plain PyTorch, no kernel, no import of
the program, so that a later change to the program cannot move it.
The scans walk every frame of a batch at once (a batch axis beside the
scan line), which changes no arithmetic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def int16_sentinel(block_size: int, cap: int) -> int | None:
    """Invalid-cost sentinel for the exact int16 x2-grid encoding, or None
    when no sentinel can both dominate every valid cost (> 4*cap on the x2
    grid) and keep block_size^2 box sums inside int16."""
    max_valid2 = 4 * cap
    s_max = 32767 // (block_size * block_size)
    if s_max > max_valid2:
        return min(s_max, 2 * max_valid2)
    return None


def prefilter_xsobel(img, cap: int):
    """Horizontal Sobel clipped to [-cap, cap] and shifted to [0, 2*cap],
    of an (H, W) image or a (B, H, W) batch."""
    H, W = img.shape[-2:]
    x = F.pad(img.to(torch.float32).reshape(-1, 1, H, W), (1, 1, 1, 1),
              mode="replicate").reshape(img.shape[:-2] + (H + 2, W + 2))

    def sh(dy, dx):
        return x[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    dx = ((sh(-1, 1) + 2 * sh(0, 1) + sh(1, 1))
          - (sh(-1, -1) + 2 * sh(0, -1) + sh(1, -1)))
    return torch.clamp(dx, -cap, cap) + cap


def _check_envelope(params: SGBMParams, cost_max: int) -> None:
    # The packed (S * D + d) argmin key must stay inside int32. S is at most
    # num_paths x (the largest box-summed cost + the larger of 2*P2 and the
    # 64 a fresh start can add).
    s_max = params.num_paths * (cost_max + max(2 * params.effective_p2, 64))
    if (s_max + 1) * params.num_disparities >= 2 ** 31:
        raise NotImplementedError("SGBM penalties too large for int32 keys")


def speckle_keep_plain(disp, valid, max_diff: int, window: int):
    """H7's plain version: (labels, keep) of (H, W) or (B, H, W)
    disparities and their valid mask, as ``ops/speckle_cuda.speckle_keep``
    gives them. Hooking (every edge between two labels sets the larger
    label's root to the smaller label) and log2(H*W) pointer jumps, repeated
    until no edge joins two labels, then ``torch.bincount`` of the labels
    for the sizes. Labels only decrease and each stays an index of its
    component, so the loop ends with every pixel labelled by its
    component's smallest flat index. Frame b's pixels hold the flat
    indices [b*H*W, (b+1)*H*W) and no edge crosses a frame, so one loop
    labels the whole batch and each frame as its own call does. Each round
    costs one host sync (the convergence test, for the whole batch),
    counted in ``speckle_filter.syncs``: a batch pays its slowest frame's
    rounds once; on raster-ordered blobs one round merges a whole convex
    component."""
    H, W = disp.shape[-2:]
    n = H * W
    total = disp.numel()
    dev = disp.device
    d = disp.to(torch.int32)
    idx = torch.arange(total, device=dev).view(disp.shape)
    conn_x = (valid[..., 1:] & valid[..., :-1]
              & ((d[..., 1:] - d[..., :-1]).abs() <= max_diff))
    conn_y = (valid[..., 1:, :] & valid[..., :-1, :]
              & ((d[..., 1:, :] - d[..., :-1, :]).abs() <= max_diff))
    # every pixel's edge to its left and upper neighbour; a missing edge is
    # a self-loop
    src = torch.cat([idx[..., 1:].reshape(-1), idx[..., 1:, :].reshape(-1)])
    dst = torch.cat([
        torch.where(conn_x, idx[..., :-1], idx[..., 1:]).reshape(-1),
        torch.where(conn_y, idx[..., :-1, :], idx[..., 1:, :]).reshape(-1)])
    labels = torch.arange(total, device=dev)
    # a label chain never leaves its frame, so n bounds its length
    jumps = max(1, (n - 1).bit_length())
    while True:
        lu, lv = labels[src], labels[dst]
        if torch.equal(lu, lv):
            break
        labels = labels.scatter_reduce(0, torch.maximum(lu, lv),
                                       torch.minimum(lu, lv), "amin")
        for _ in range(jumps):
            labels = labels[labels]
    size = torch.bincount(labels, minlength=total)
    keep = valid & (size[labels] > window).view(disp.shape)
    return labels.to(torch.int32).view(disp.shape), keep


_BIG = 1 << 28      # "infinite" L at the disparity range's ends (x2 grid)


_BIG_KEY = 1 << 30  # out-of-range right-view cost (x2 grid)


BIG_F = 1e9         # the JAX package's float32 carry and fill (sgbm.BIG)


XSHIFTS = (0, 1, -1)  # the vertical directions, in the JAX package's order


def fresh_start(c2):
    """First L of a scan on the x2 grid: ``c2`` rounded half-to-even to a
    multiple of 128 (float32 ``(c + 1e9) - 1e9`` on the x1 grid)."""
    return (torch.round(c2.to(torch.float32) / 128.0) * 128.0).to(torch.int32)


def _bt_cost(lp, rp, min_disp: int, num_disp: int, bf16: bool):
    """(..., H, W, D) float32 Birchfield-Tomasi cost of (..., H, W) images,
    NaN where the right image's column, or a neighbour's, falls outside the
    image. Neighbours at x +/- 1 wrap around the row (``jnp.roll``), as in
    the JAX package. With ``bf16`` the images and every add and subtract
    are rounded to bfloat16, as XLA does; otherwise the arithmetic is
    float32. Every operation is elementwise or gathers within a row, so a
    batch gives each frame its own call's bits."""
    W = lp.shape[-1]
    dev = lp.device
    wd = torch.bfloat16 if bf16 else torch.float32
    lp = lp.to(wd)
    rp = rp.to(wd)
    d = torch.arange(num_disp, device=dev)
    x = torch.arange(W, device=dev)
    src = x[:, None] - min_disp - d[None, :]
    ok = (src >= 0) & (x[:, None] - min_disp <= W - 1)
    r_sh = torch.where(ok, rp[..., src.clamp(0, W - 1)], float("nan"))

    def envelopes(a, x_dim):
        am = 0.5 * (a + torch.roll(a, 1, dims=x_dim))
        ap = 0.5 * (a + torch.roll(a, -1, dims=x_dim))
        lo = torch.minimum(torch.minimum(am, ap), a)
        hi = torch.maximum(torch.maximum(am, ap), a)
        return lo, hi

    l_lo, l_hi = envelopes(lp, -1)
    r_lo, r_hi = envelopes(r_sh, -2)
    lp3 = lp[..., None]
    zero = torch.zeros((), dtype=wd, device=dev)
    c_l = torch.maximum(zero, torch.maximum(lp3 - r_hi, r_lo - lp3))
    c_r = torch.maximum(zero, torch.maximum(r_sh - l_hi[..., None],
                                            l_lo[..., None] - r_sh))
    return torch.minimum(c_l, c_r).to(torch.float32)


def bt_cost_volume2(lp, rp, min_disp: int, num_disp: int, sentinel: int,
                    bf16: bool):
    """(H, W, D) int32 Birchfield-Tomasi cost x2 between prefiltered images
    (:func:`_bt_cost` doubled and truncated), ``sentinel`` where a sample
    falls outside the image."""
    cost = _bt_cost(lp, rp, min_disp, num_disp, bf16)
    return torch.where(torch.isnan(cost), float(sentinel),
                       cost * 2.0).to(torch.int32)


def block_sum(vol, block_size: int):
    """block_size x block_size box sum of an (..., H, W, D) volume with
    edge-replicated borders, in the JAX package's order: rows i =
    0..bs-1 added one at a time, then columns the same way. Exact for
    integers. The adds are elementwise, so a batch of frames gives each
    its own call's bits."""
    rows = vol.shape[-3]
    row0, lo, hi = 0, 0, rows - 1
    r = block_size // 2
    W = vol.shape[-2]
    dev = vol.device
    ys = torch.arange(row0, row0 + rows, device=dev)
    acc = vol[..., (ys - r).clamp(lo, hi), :, :]
    for i in range(1, block_size):
        acc += vol[..., (ys + i - r).clamp(lo, hi), :, :]
    xs = torch.arange(W, device=dev)
    out = acc[..., (xs - r).clamp(0, W - 1), :]
    for i in range(1, block_size):
        out += acc[..., (xs + i - r).clamp(0, W - 1), :]
    return out


def _shift_x(prev, k: int, fill):
    """prev at offset -k along its scan-line axis (-2, ahead of the
    disparities; ``_shift_x`` of the JAX package), ``fill`` where that falls
    outside. Leading axes are frames of a batch."""
    if k == 0:
        return prev
    pad = torch.full_like(prev[..., :1, :], fill)
    if k == 1:
        return torch.cat([pad, prev[..., :-1, :]], -2)
    return torch.cat([prev[..., 1:, :], pad], -2)


def _step(pr, c, p1, p2, big):
    """One recurrence step L = C + min(L', L'(d+-1) + P1, min L' + P2) - min L'
    over the last axis; in float32 each operation rounds as in the JAX
    package's ``_scan_dirs``."""
    minprev = pr.amin(-1, keepdim=True)
    fill = torch.full_like(pr[..., :1], big)
    dn = torch.cat([fill, pr[..., :-1]], -1)
    up = torch.cat([pr[..., 1:], fill], -1)
    cand = torch.minimum(pr, torch.minimum(dn, up) + p1)
    cand = torch.minimum(cand, minprev + p2)
    return (c + cand) - minprev


def _rows(n0: int, reverse: bool):
    return range(n0 - 1, -1, -1) if reverse else range(n0)


def sgm_scan(cost2, xshift: int, p1: int, p2: int, reverse: bool = False,
             init=None, return_carry: bool = False):
    """L of one direction along axis 0 of an (N0, ..., N1, D) cost on the x2
    grid, as int32 (axes between N0 and N1 are frames walked together); the previous L is read at axis-1 offset ``-xshift``
    (0: straight, +1/-1: diagonal), also when the scan runs backwards
    (``reverse``), as in the JAX package's ``_scan_dirs``.

    The first row walked takes its previous L from ``init`` (N1, D) int32,
    shifted like any other, or starts afresh without it; a line whose
    shifted-in previous value is absent (column 0 for +1, N1 - 1 for -1)
    starts afresh on every row (``_shift_carry``,
    ``openvo_tpu/ops/sgbm_pallas.py:415-421``). ``return_carry`` also
    returns the L of the last row walked."""
    out = torch.empty_like(cost2, dtype=torch.int32)
    prev = init
    for i in _rows(cost2.shape[0], reverse):
        c = cost2[i].to(torch.int32)
        if prev is None:
            L = fresh_start(c)
        else:
            L = _step(_shift_x(prev, xshift, _BIG), c, p1, p2, _BIG)
            if xshift == 1:
                L[..., 0, :] = fresh_start(c[..., 0, :])
            elif xshift == -1:
                L[..., -1, :] = fresh_start(c[..., -1, :])
        out[i] = L
        prev = L
    return (out, prev) if return_carry else out


def scan_f32(cost, xshift: int, p1: float, p2: float, reverse: bool = False):
    """:func:`sgm_scan` on the x1 grid in float32, literally the JAX
    package's ``_scan_dirs`` for one direction: the carry starts at 1e9,
    the shift fills 1e9, and the first L of a line is ``(c + 1e9) - 1e9``
    by the recurrence itself. Axes as :func:`sgm_scan`'s."""
    out = torch.empty_like(cost, dtype=torch.float32)
    prev = torch.full(cost.shape[1:], BIG_F, dtype=torch.float32,
                      device=cost.device)
    for i in _rows(cost.shape[0], reverse):
        prev = _step(_shift_x(prev, xshift, BIG_F), cost[i], float(p1),
                     float(p2), BIG_F)
        out[i] = prev
    return out


def _rows_of(C):
    """C's rows as one (rows, W, D) volume: a batch's frames one after
    another (each row is a scan line of its own)."""
    return C.reshape((-1,) + tuple(C.shape[-2:]))


def hsweep_wta_lr_plain(C, s1, sv, p1, p2, min_disp, uniqueness, disp12,
                        svu=None):
    """Plain H3: the right-to-left scan L, S = L + s1 + sv (+ svu), WTA
    (lowest d on ties), uniqueness, parabolic subpixel on the x16 grid,
    left-right check, left band and the invalid value -> (H, W) int16.

    Over int16 C the sums are int32 on the x2 grid, and ``sv`` may be None
    where s1 already holds the vertical sum (H2 added into it); over
    float32 C they are float32 in the JAX package's order,
    ``((s1 + L) + sv) + svu``. (B, H, W, D) volumes give (B, H, W): every
    step is row-local, so the frames' rows are walked as one volume's."""
    if C.ndim == 4:
        rows = [None if t is None else _rows_of(t) for t in (s1, sv, svu)]
        return hsweep_wta_lr_plain(
            _rows_of(C), rows[0], rows[1], p1, p2, min_disp, uniqueness,
            disp12, rows[2]).view(C.shape[:-1])
    H, W, D = C.shape
    dev = C.device
    f32 = C.dtype == torch.float32
    Ct = C.transpose(0, 1)
    if f32:
        L = scan_f32(Ct, 0, p1, p2, reverse=True).transpose(0, 1)
        S = (s1 + L) + sv
    else:
        L = sgm_scan(Ct, 0, p1, p2, reverse=True).transpose(0, 1)
        S = L + s1 if sv is None else L + s1 + sv
    if svu is not None:
        S = S + svu
    best = S.argmin(-1)
    minS = S.amin(-1)
    d_idx = torch.arange(D, device=dev)
    valid = torch.ones((H, W), dtype=torch.bool, device=dev)
    if uniqueness > 0:
        # the JAX package's float32 test on the x1 grid: the products round
        # once S * 90 passes 2^24 (blockSize 13, 5 paths)
        far = (d_idx - best[..., None]).abs() > 1
        scale = 1.0 if f32 else 0.5
        s_x1 = S.to(torch.float32) * scale
        ms_x1 = minS.to(torch.float32) * scale
        bad = (far & (s_x1 * float(100 - uniqueness)
                      < (ms_x1 * 100.0)[..., None])).any(-1)
        valid &= ~bad
    s_m = S.gather(-1, (best - 1).clamp(0, D - 1)[..., None])[..., 0]
    s_p = S.gather(-1, (best + 1).clamp(0, D - 1)[..., None])[..., 0]
    # On the x2 grid the integer ratio (s_m - s_p) / (2 denom) is the same
    # real number as on the x1 grid, and both operands are exact: the
    # float32 quotient is identical.
    denom = (s_m + s_p) - 2 * minS
    interior = (best > 0) & (best < D - 1) & (denom > 0)
    ratio = (s_m - s_p).to(torch.float32) / torch.clamp_min(
        2.0 * denom.to(torch.float32), 1e-9)
    frac = torch.where(interior, ratio, 0.0).clamp(-0.5, 0.5)
    d_float = (best.to(torch.float32) + frac) + min_disp
    disp16 = torch.round(d_float * 16.0).to(torch.int32)
    x = torch.arange(W, device=dev)
    if disp12 >= 0:
        # right-view WTA: costR(xr, d) = S(xr + d, d)
        src = x[:, None] + d_idx[None, :]
        costR = torch.where((src < W)[None],
                            S[:, src.clamp(max=W - 1), d_idx[None, :]],
                            BIG_F if f32 else _BIG_KEY)
        bestR = costR.argmin(-1)
        xr = x[None, :] - best
        dR = torch.where(xr >= 0, bestR.gather(1, xr.clamp(min=0)), -(1 << 20))
        valid &= ((best - dR).abs() <= disp12) | (xr < 0)
    valid &= (x[None, :] - (best + min_disp)) >= 0
    return torch.where(valid, disp16, (min_disp - 1) * 16).to(torch.int16)



def _box_cost_f32(lp, rp, params, cap: int, low: bool):
    """Box-summed (B, H, W, D) float32 cost on the x1 grid for a
    configuration without an int16 sentinel: the BT cost without doubling
    or truncation, 4*cap where a sample falls outside the image, box-summed
    in float32 (``cost_volume_f32`` of the program's plain versions). With
    ``low`` the sum is held in bfloat16 (the control)."""
    cost = _bt_cost(lp, rp, params.min_disparity, params.num_disparities,
                    2 * cap <= 127)
    cost = torch.where(torch.isnan(cost), float(4 * cap), cost)
    C = block_sum(cost, params.block_size)
    return C.to(torch.bfloat16).to(torch.float32) if low else C


def disparity16(left, right, params, cost_bits: int = 16):
    """(B, H, W) int16 disparity on the x16 grid of (B, H, W) rectified
    float32 pairs, invalid = (minDisparity - 1) * 16, by the 5-path SGBM:
    on the int16 path where a sentinel exists for the configuration's block
    size and cap, else on the float32 path (x1 grid, the sums in the JAX
    package's order). ``cost_bits`` 8 holds the box-summed cost in 8 bits
    on the int16 path and in bfloat16 on the float32 path (the control's
    lower precision); 16 is the configuration's."""
    if params.num_paths != 5:
        raise NotImplementedError("the reference holds the 5-path SGBM only")
    cap = max(params.pre_filter_cap, 15) | 1
    sent = int16_sentinel(params.block_size, cap)
    lp = prefilter_xsobel(left, cap)
    rp = prefilter_xsobel(right, cap)
    if sent is None:
        p1, p2 = params.effective_p1, params.effective_p2
        C = _box_cost_f32(lp, rp, params, cap, cost_bits == 8)
        scan = scan_f32
    else:
        _check_envelope(params, params.block_size ** 2 * sent)
        p1, p2 = 2 * params.effective_p1, 2 * params.effective_p2
        C = block_sum(bt_cost_volume2(lp, rp, params.min_disparity,
                                      params.num_disparities, sent,
                                      2 * cap <= 127),
                      params.block_size).to(torch.int16)
        if cost_bits == 8:
            step = -(-params.block_size ** 2 * sent // 255)
            C = (torch.round(C.to(torch.float32) / step).clamp(0, 255)
                 * step).to(torch.int16)
        scan = sgm_scan
    # left to right along each row, then top-down with both diagonals,
    # summed (L(0) + L(+1)) + L(-1) (exact over int16, float32's order)
    s1 = scan(C.permute(2, 0, 1, 3), 0, p1, p2).permute(1, 2, 0, 3)
    Cv = C.permute(1, 0, 2, 3)
    sv = None
    for k in XSHIFTS:
        L = scan(Cv, k, p1, p2).permute(1, 0, 2, 3)
        sv = L if sv is None else sv + L
    if sent is not None:   # exact in integers: the vertical sum into s1
        s1, sv = s1 + sv, None
    out = hsweep_wta_lr_plain(C, s1, sv, p1, p2, params.min_disparity,
                              params.uniqueness_ratio,
                              params.disp12_max_diff)
    if params.speckle_window_size > 0 and params.speckle_range > 0:
        invalid = (params.min_disparity - 1) * 16
        valid = out != invalid
        keep = speckle_keep_plain(out, valid, 16 * params.speckle_range,
                                  params.speckle_window_size)[1]
        out = torch.where(keep, out, invalid)
    return out
