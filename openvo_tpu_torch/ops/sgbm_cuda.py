"""SGBM volume kernels H1, H2, H3 and H5 (``csrc/sgbm.cu``) and their plain
versions.

Everything here works on the exact x2 grid: costs are the Birchfield-Tomasi
half-integer costs times two, held as integers, and penalties are 2*P1 and
2*P2. Two roundings of the JAX package's CPU path are reproduced on purpose:

- the cost itself: for ``2*cap <= 127`` the JAX package computes the
  envelopes and the cost in bfloat16, rounding after every add and
  subtract, then truncates the doubled cost to an integer
  (:func:`bt_cost_volume2` with ``bf16``). On integer images this is exact;
  on the fractional images of a distorting camera's remap it is not.
- a scan starts from a carry of 1e9, so its first L is ``(c + 1e9) - 1e9``
  in float32, which rounds ``c`` half-to-even to a multiple of 64 (x1
  grid), i.e. the x2 cost to a multiple of 128 (:func:`fresh_start`). That
  happens at the first column of a horizontal scan, the first row of a
  vertical one, and every row's edge column of a diagonal one.

Every other step of the aggregation is exact integer arithmetic, so any
summation order gives the same bits.

Volumes are (H, W, D) with the disparity axis innermost: one thread per
disparity reads and writes D neighbouring values at each pixel.

Kernels (one wrapper each; a CPU tensor runs the plain version, a CUDA
tensor launches the kernel or raises):

- H1 :func:`cost_hsweep`: int16 cost volume + box sum + left-to-right scan.
- H2 :func:`vsweep`: the vertical scans (straight, or with both
  diagonals), top-down, bottom-up or both, summed into one int32 volume.
- H5 :func:`hsweep`: one horizontal scan over an int32 cost volume, with an
  optional accumulator.
- H3 :func:`hsweep_wta_lr`: right-to-left scan, WTA, uniqueness, subpixel,
  left-right check and the invalid encoding, to the final int16 disparity;
  over an int16 or an int32 cost volume.

Without an int16 sentinel the cost volume is built by :func:`cost_volume`,
plain PyTorch on every device (the JAX package leaves that stage to XLA).
"""

from __future__ import annotations

import torch

from openvo_tpu_torch import _build
from openvo_tpu_torch.ops._dispatch import (check_cuda_input, device_of,
                                            stream_handle)

_BIG = 1 << 28      # "infinite" L at the disparity range's ends
_BIG_KEY = 1 << 30  # out-of-range right-view cost


def fresh_start(c2):
    """First L of a scan on the x2 grid: ``c2`` rounded half-to-even to a
    multiple of 128 (float32 ``(c + 1e9) - 1e9`` on the x1 grid)."""
    return (torch.round(c2.to(torch.float32) / 128.0) * 128.0).to(torch.int32)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def bt_cost_volume2(lp, rp, min_disp: int, num_disp: int, sentinel: int,
                    bf16: bool):
    """(H, W, D) int32 Birchfield-Tomasi cost x2 between prefiltered images,
    with the JAX package's edge semantics: neighbours at x +/- 1 wrap around
    the row (``jnp.roll``), and any sample whose right-image column, or a
    neighbour's, falls outside the image gets ``sentinel``.

    With ``bf16`` (the JAX package's choice when ``2*cap <= 127``) the
    images are rounded to bfloat16 and every add and subtract of the
    envelopes and the cost is rounded to bfloat16, as XLA does; the doubled
    cost is then truncated to an integer. Otherwise the arithmetic is
    float32."""
    H, W = lp.shape
    dev = lp.device
    wd = torch.bfloat16 if bf16 else torch.float32
    lp = lp.to(wd)
    rp = rp.to(wd)
    d = torch.arange(num_disp, device=dev)
    x = torch.arange(W, device=dev)
    src = x[:, None] - min_disp - d[None, :]
    ok = (src >= 0) & (x[:, None] - min_disp <= W - 1)
    nan = torch.tensor(float("nan"), dtype=wd, device=dev)
    r_sh = torch.where(ok[None], rp[:, src.clamp(0, W - 1)], nan)

    def envelopes(a):
        am = 0.5 * (a + torch.roll(a, 1, dims=1))
        ap = 0.5 * (a + torch.roll(a, -1, dims=1))
        lo = torch.minimum(torch.minimum(am, ap), a)
        hi = torch.maximum(torch.maximum(am, ap), a)
        return lo, hi

    l_lo, l_hi = envelopes(lp)
    r_lo, r_hi = envelopes(r_sh)
    lp3 = lp[..., None]
    zero = torch.zeros((), dtype=wd, device=dev)
    c_l = torch.maximum(zero, torch.maximum(lp3 - r_hi, r_lo - lp3))
    c_r = torch.maximum(zero, torch.maximum(r_sh - l_hi[..., None],
                                            l_lo[..., None] - r_sh))
    cost = torch.minimum(c_l, c_r).to(torch.float32)
    cost2 = torch.where(torch.isnan(cost), float(sentinel), cost * 2.0)
    return cost2.to(torch.int32)


def block_sum(vol, block_size: int):
    """block_size x block_size box sum of an (H, W, D) integer volume with
    edge-replicated borders, as int32 (exact)."""
    v = vol.to(torch.int32)
    if block_size <= 1:
        return v
    r = block_size // 2
    H, W = vol.shape[:2]
    dev = vol.device
    rows = torch.arange(H, device=dev)
    acc = sum(v[(rows + i - r).clamp(0, H - 1)] for i in range(block_size))
    cols = torch.arange(W, device=dev)
    return sum(acc[:, (cols + i - r).clamp(0, W - 1)]
               for i in range(block_size))


def cost_volume(lp, rp, min_disp: int, num_disp: int, block_size: int,
                sentinel: int, bf16: bool):
    """Box-summed (H, W, D) int32 cost x2, for configurations without an
    int16 sentinel (``sentinel`` = 8*cap, the JAX package's 4*cap on the x1
    grid). Plain PyTorch on every device, as the JAX package leaves this
    stage to XLA; on integer images it equals the JAX float32 volume x2."""
    return block_sum(bt_cost_volume2(lp, rp, min_disp, num_disp, sentinel,
                                     bf16), block_size)


def sgm_step(prev, c2, p1: int, p2: int):
    """One recurrence step L = C + min(L', L'(d+-1) + P1, min L' + P2) - min L'
    over the last axis, on int32."""
    minprev = prev.amin(-1, keepdim=True)
    big = torch.full_like(prev[..., :1], _BIG)
    dn = torch.cat([big, prev[..., :-1]], -1)
    up = torch.cat([prev[..., 1:], big], -1)
    cand = torch.minimum(prev, torch.minimum(dn, up) + p1)
    cand = torch.minimum(cand, minprev + p2)
    return c2 + cand - minprev


def sgm_scan(cost2, xshift: int, p1: int, p2: int, reverse: bool = False):
    """L of one direction along axis 0 of an (N0, N1, D) int32 cost; the
    previous L is read at axis-1 offset ``-xshift`` (0: straight, +1/-1:
    diagonal), also when the scan runs backwards (``reverse``), as in the
    JAX package's ``_scan_dirs``. Starts afresh at the first row walked and
    at the edge column a diagonal shifts in (column 0 for +1, N1 - 1 for
    -1, in either order)."""
    n0 = cost2.shape[0]
    out = torch.empty_like(cost2, dtype=torch.int32)
    prev = None
    for i in (range(n0 - 1, -1, -1) if reverse else range(n0)):
        c = cost2[i].to(torch.int32)
        if prev is None:
            L = fresh_start(c)
        else:
            pr = prev
            if xshift == 1:
                pr = torch.cat([torch.full_like(prev[:1], _BIG), prev[:-1]])
            elif xshift == -1:
                pr = torch.cat([prev[1:], torch.full_like(prev[:1], _BIG)])
            L = sgm_step(pr, c, p1, p2)
            if xshift == 1:
                L[0] = fresh_start(c[0])
            elif xshift == -1:
                L[-1] = fresh_start(c[-1])
        out[i] = L
        prev = L
    return out


def cost_hsweep_plain(lp, rp, min_disp, num_disp, block_size, sentinel, p1,
                      p2, bf16):
    """Plain H1: (C (H, W, D) int16, s1 (H, W, D) int32 forward
    horizontal L), penalties on the x2 grid."""
    C = cost_volume(lp, rp, min_disp, num_disp, block_size, sentinel,
                    bf16).to(torch.int16)
    s1 = sgm_scan(C.transpose(0, 1), 0, p1, p2).transpose(0, 1)
    return C, s1.contiguous()


def vsweep_plain(C, p1, p2, diagonals: bool, down: bool = True,
                 up: bool = False):
    """Plain H2: the sum, as int32, of the vertical scans (with both
    diagonals if ``diagonals``) walked top-down (``down``) and bottom-up
    (``up``)."""
    xshifts = (0, 1, -1) if diagonals else (0,)
    ways = [False] * down + [True] * up
    return sum(sgm_scan(C, k, p1, p2, reverse=r) for r in ways
               for k in xshifts)


def hsweep_plain(C, p1, p2, reverse: bool = False, accum=None):
    """Plain H5: L of the left-to-right (or, ``reverse``, right-to-left)
    scan of an (H, W, D) int32 cost, plus ``accum`` if given."""
    L = sgm_scan(C.transpose(0, 1), 0, p1, p2, reverse).transpose(0, 1)
    return (L if accum is None else L + accum).contiguous()


def hsweep_wta_lr_plain(C, s1, sv, p1, p2, min_disp, uniqueness, disp12):
    """Plain H3: the right-to-left scan, S = L + s1 + sv, WTA (lowest d on
    ties), uniqueness, parabolic subpixel on the x16 grid, left-right
    check, left band and the invalid value -> (H, W) int16."""
    H, W, D = C.shape
    dev = C.device
    L = sgm_scan(C.transpose(0, 1), 0, p1, p2, reverse=True).transpose(0, 1)
    S = L + s1 + sv
    best = S.argmin(-1)
    minS = S.amin(-1)
    d_idx = torch.arange(D, device=dev)
    valid = torch.ones((H, W), dtype=torch.bool, device=dev)
    if uniqueness > 0:
        # the JAX package's float32 test on the x1 grid: the products round
        # once S * 90 passes 2^24 (blockSize 13, 5 paths)
        far = (d_idx - best[..., None]).abs() > 1
        s_x1 = S.to(torch.float32) * 0.5
        ms_x1 = minS.to(torch.float32) * 0.5
        bad = (far & (s_x1 * float(100 - uniqueness)
                      < (ms_x1 * 100.0)[..., None])).any(-1)
        valid &= ~bad
    s_m = S.gather(-1, (best - 1).clamp(0, D - 1)[..., None])[..., 0]
    s_p = S.gather(-1, (best + 1).clamp(0, D - 1)[..., None])[..., 0]
    denom = s_m + s_p - 2 * minS
    interior = (best > 0) & (best < D - 1) & (denom > 0)
    # x1-grid (s_m - s_p) / (2 denom) is the same real number as this x2
    # ratio, and both operands are exact: the float32 quotient is identical.
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
                            _BIG_KEY)
        bestR = costR.argmin(-1)
        xr = x[None, :] - best
        dR = torch.where(xr >= 0, bestR.gather(1, xr.clamp(min=0)), -(1 << 20))
        valid &= ((best - dR).abs() <= disp12) | (xr < 0)
    valid &= (x[None, :] - (best + min_disp)) >= 0
    return torch.where(valid, disp16, (min_disp - 1) * 16).to(torch.int16)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_C_TYPES = (torch.int16, torch.int32)


def cost_hsweep(lp, rp, min_disp: int, num_disp: int, block_size: int,
                sentinel: int, p1: int, p2: int, bf16: bool):
    """H1, replacing ``sgbm_pallas.cost_sweep_fused`` (K1). (C int16, s1
    int32) for float32 prefiltered images; penalties on the x2 grid;
    ``bf16`` rounds the cost arithmetic as :func:`bt_cost_volume2`.

    One block per image row, one thread per disparity, walking x left to
    right: the BT cost of the 2r+1 rows around the row, their column sum
    (edge rows replicated) into a per-thread ring of 2r+1 column sums for
    the sliding horizontal box sum, then the forward SGM step with the min
    over d by warp shuffles and shared memory. Bound on the H100 by the
    serial walk over W (one block barrier per column) rather than by bytes:
    it writes 6 bytes per volume element. The design keeps every cost
    intermediate in registers and only C and s1 reach device memory."""
    dev = device_of(lp, rp)
    if dev.type == "cpu":
        return cost_hsweep_plain(lp, rp, min_disp, num_disp, block_size,
                                 sentinel, p1, p2, bf16)
    H, W = lp.shape
    check_cuda_input(lp, torch.float32, (H, W), "lp")
    check_cuda_input(rp, torch.float32, (H, W), "rp")
    _check_disparities(num_disp)
    lib = _build.library()
    C = torch.empty((H, W, num_disp), dtype=torch.int16, device=dev)
    s1 = torch.empty((H, W, num_disp), dtype=torch.int32, device=dev)
    err = lib.ovo_cost_hsweep(lp.data_ptr(), rp.data_ptr(), C.data_ptr(),
                              s1.data_ptr(), H, W, num_disp, min_disp,
                              block_size // 2, sentinel, p1, p2, int(bf16),
                              stream_handle(dev))
    cost_hsweep.launches += 1
    _build.check_launch(err, "cost_hsweep")
    return C, s1


def vsweep(C, p1: int, p2: int, diagonals: bool, down: bool = True,
           up: bool = False):
    """H2, replacing ``sgbm_pallas.sweep_v`` (K2) in its forward and reverse,
    one- and three-direction variants. The sum of the vertical scans
    (straight, or with both diagonals) walked top-down and/or bottom-up,
    as (H, W, D) int32, over an int16 or int32 C: 5 paths take the
    top-down trio, 8 paths both trios, 4 paths the straight line both ways.

    One block per scan line, one thread per disparity: W vertical lines and
    W+H-1 lines for each diagonal, per direction of travel, all in one
    launch, each walked with its carry in shared memory. Every line adds
    into one zeroed int32 volume with integer atomics, exact in any order.
    Bound by the serial walk over H per line; the 4476 lines of the
    top-down trio at KITTI size fill the card about twice over."""
    dev = device_of(C)
    if dev.type == "cpu":
        return vsweep_plain(C, p1, p2, diagonals, down, up)
    H, W, D = C.shape
    _check_cost(C, (H, W, D))
    _check_disparities(D)
    if not (down or up):
        raise ValueError("vsweep: no direction of travel")
    lib = _build.library()
    sv = torch.zeros((H, W, D), dtype=torch.int32, device=dev)
    err = lib.ovo_vsweep(C.data_ptr(), C.element_size(), sv.data_ptr(), H, W,
                         D, p1, p2, int(diagonals), int(down), int(up),
                         stream_handle(dev))
    vsweep.launches += 1
    _build.check_launch(err, "vsweep")
    return sv


def hsweep(C, p1: int, p2: int, reverse: bool = False, accum=None):
    """H5, replacing ``sgbm_pallas.sweep_h`` (K6). L of one horizontal scan
    over an (H, W, D) int32 cost, left to right or (``reverse``) right to
    left, plus ``accum`` if given, as int32; the configurations without an
    int16 sentinel take their forward partial s1 from it.

    One block per row, one thread per disparity, walking x with the
    previous L in shared memory and the min over d by warp shuffles. Bound
    by the serial walk over W, one block barrier per column; it moves 8
    (12 with ``accum``) bytes per volume element."""
    dev = device_of(C) if accum is None else device_of(C, accum)
    if dev.type == "cpu":
        return hsweep_plain(C, p1, p2, reverse, accum)
    H, W, D = C.shape
    check_cuda_input(C, torch.int32, (H, W, D), "C")
    if accum is not None:
        check_cuda_input(accum, torch.int32, (H, W, D), "accum")
    _check_disparities(D)
    lib = _build.library()
    out = torch.empty((H, W, D), dtype=torch.int32, device=dev)
    err = lib.ovo_hsweep(C.data_ptr(),
                         None if accum is None else accum.data_ptr(),
                         out.data_ptr(), H, W, D, p1, p2, int(reverse),
                         stream_handle(dev))
    hsweep.launches += 1
    _build.check_launch(err, "hsweep")
    return out


def hsweep_wta_lr(C, s1, sv, p1: int, p2: int, min_disp: int,
                  uniqueness: int, disp12: int):
    """H3, replacing ``sgbm_pallas.sweep_hw_wta`` (K3) and, over an int32
    C, ``sweep_h_wta`` (K7), with ``lr_lookup`` (K4) and the post-pass
    between them. Final (H, W) int16 disparity x16.

    One block per row, one thread per disparity, walking x right to left:
    the reverse scan, S = L + s1 + sv, one packed (S * D + d) min for the
    argmin with the lowest d, the uniqueness vote by warp ballots, and the
    right-view argmin over a D-slot ring of packed keys (slot x - d gets
    S(x, d); slot x is complete once column x is done). best, bestR,
    min S and S(best -+ 1) for the row stay in shared memory; an epilogue
    in the same kernel does subpixel, the LR lookup bestR[x - best] (K4 as
    a shared-memory read), uniqueness and the invalid encoding. Bound by the
    serial walk over W; reads 10 (12 over int32 C) bytes per volume
    element."""
    dev = device_of(C, s1, sv)
    if dev.type == "cpu":
        return hsweep_wta_lr_plain(C, s1, sv, p1, p2, min_disp, uniqueness,
                                   disp12)
    H, W, D = C.shape
    _check_cost(C, (H, W, D))
    check_cuda_input(s1, torch.int32, (H, W, D), "s1")
    check_cuda_input(sv, torch.int32, (H, W, D), "sv")
    _check_disparities(D)
    lib = _build.library()
    out = torch.empty((H, W), dtype=torch.int16, device=dev)
    err = lib.ovo_hsweep_wta_lr(C.data_ptr(), C.element_size(), s1.data_ptr(),
                                sv.data_ptr(), out.data_ptr(), H, W, D, p1,
                                p2, min_disp, uniqueness, disp12,
                                stream_handle(dev))
    hsweep_wta_lr.launches += 1
    _build.check_launch(err, "hsweep_wta_lr")
    return out


cost_hsweep.launches = 0
vsweep.launches = 0
hsweep.launches = 0
hsweep_wta_lr.launches = 0

KERNELS = (cost_hsweep, vsweep, hsweep, hsweep_wta_lr)


def _check_cost(C, shape) -> None:
    if C.dtype not in _C_TYPES:
        raise TypeError(f"C: dtype {C.dtype}, expected int16 or int32")
    check_cuda_input(C, C.dtype, shape, "C")


def _check_disparities(D: int) -> None:
    # one thread per disparity in one block
    if not 1 <= D <= 1024:
        raise ValueError(f"the CUDA SGBM kernels need num_disparities in "
                         f"[1, 1024], got {D}")
