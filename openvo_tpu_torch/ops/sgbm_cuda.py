"""SGBM volume kernels H1, H2, H3 and H5 (``csrc/sgbm.cu``) and their plain
versions.

Two arithmetic paths, each reproducing the JAX package's CPU path bit for
bit:

- **int16 (x2 grid)**, where an int16 sentinel exists (the default
  configurations): costs are the Birchfield-Tomasi half-integer costs times
  two, held as integers, and penalties are 2*P1 and 2*P2. For ``2*cap <=
  127`` the JAX package computes the envelopes and the cost in bfloat16,
  rounding after every add and subtract, then truncates the doubled cost
  (:func:`bt_cost_volume2` with ``bf16``). A scan starts from a float32
  carry of 1e9, so its first L is ``(c + 1e9) - 1e9``, which rounds ``c``
  half-to-even to a multiple of 64 (x1 grid), i.e. the x2 cost to a
  multiple of 128 (:func:`fresh_start`): at the first column of a
  horizontal scan, the first row of a vertical one, and every row's edge
  column of a diagonal one. Every other step is exact integer arithmetic,
  so any summation order gives the same bits.
- **float32 (x1 grid)**, without an int16 sentinel (blockSize >= 13 at
  preFilterCap 63, or cap > 327): the JAX package keeps the (bfloat16 or
  float32) cost in float32 through the box sum, the scans (a carry of 1e9)
  and the WTA. On fractional images these roundings matter, so every
  function here does JAX's float32 operations in JAX's order
  (:func:`cost_volume_f32`, :func:`scan_f32`), and the kernels use
  ``__fadd_rn``/``__fsub_rn``/``__fmul_rn`` so that nothing is contracted.

Volumes are (H, W, D) with the disparity axis innermost: a warp (H1's
walk, H2, H3, H5) reads and writes the D neighbouring values of a pixel at
each step of its scan line.

Kernels (one wrapper each; a CPU tensor runs the plain version, a CUDA
tensor launches the kernel or raises):

- H1 :func:`cost_hsweep`: int16 cost volume + box sum + left-to-right scan,
  of a whole image or of a row band with halo rows (K1's ``band_halo``).
- H2 :func:`vsweep`: the vertical scans (straight, or with both
  diagonals), over int16 or float32 C, with an optional carry in and out
  (K2's ``init_carry``/``return_carry``): a warp a scan line
  (``csrc/sgbm.cu``), or for a batch of the int16 trio a row-synchronous
  walk (``csrc/sgbm_trio.cu``), as :func:`vsweep_design` chooses.
- H5 :func:`hsweep`: the left-to-right scan over a float32 cost volume.
- H3 :func:`hsweep_wta_lr`: right-to-left scan, WTA, uniqueness, subpixel,
  left-right check and the invalid encoding, to the final int16 disparity;
  over int16 or float32 C.

The float32 cost volume and box sum (:func:`cost_volume_f32`) are plain
PyTorch on every device, as the JAX package leaves that stage to XLA; a
batch of frames runs through them in one pass.

Every wrapper also takes a batch of frames, a leading axis on each input
((B, H, W) images, (B, H, W, D) volumes), and launches each kernel once
for the batch, as ``jax.vmap`` gives a Pallas kernel a batch grid axis; a
frame changes only a base offset, so a batched launch gives B single-frame
launches' bits. The plain versions take a batch too: the row walks (H3,
H5) fold it into their rows, the others (H1's box sum, H2's columns)
run frame by frame.

The JAX stages of ``openvo_tpu/ops/sgbm.py`` that have no function of the
same name here, and their counterparts:

- ``bt_cost_volume`` (``:77``): :func:`_bt_cost` (the Birchfield-Tomasi
  cost), :func:`bt_cost_volume2` (on the int16 x2 grid) and
  :func:`cost_volume_f32` (float32, with the box sum);
- ``block_sum`` (``:160``): :func:`block_sum` (and a row band), inside H1
  on the int16 paths;
- ``aggregate`` (``:232``, the scans and their sum): H1
  :func:`cost_hsweep` and H5 :func:`hsweep` (left to right), H2
  :func:`vsweep` (vertical and diagonal), H3 :func:`hsweep_wta_lr` (right
  to left, with the WTA); their plain versions :func:`sgm_scan`,
  :func:`scan_f32`, :func:`vsweep_plain`, :func:`hsweep_plain`.
"""

from __future__ import annotations

import torch

from openvo_tpu_torch import _build, trace
from openvo_tpu_torch.ops._dispatch import (check_cuda_input, device_of,
                                            stream_handle)

_BIG = 1 << 28      # "infinite" L at the disparity range's ends (x2 grid)
_BIG_KEY = 1 << 30  # out-of-range right-view cost (x2 grid)
BIG_F = 1e9         # the JAX package's float32 carry and fill (sgbm.BIG)
XSHIFTS = (0, 1, -1)  # the vertical directions, in the JAX package's order


def _over_frames(fn, *tensors):
    """``fn`` applied to each frame of ``tensors`` (None passes through),
    its outputs (tensors or tuples of tensors) stacked on a new leading
    axis: a kernel's plain version on a batch, frame by frame."""
    outs = [fn(*(None if t is None else t[i] for t in tensors))
            for i in range(tensors[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def fresh_start(c2):
    """First L of a scan on the x2 grid: ``c2`` rounded half-to-even to a
    multiple of 128 (float32 ``(c + 1e9) - 1e9`` on the x1 grid)."""
    return (torch.round(c2.to(torch.float32) / 128.0) * 128.0).to(torch.int32)


# ---------------------------------------------------------------------------
# plain versions: the cost
# ---------------------------------------------------------------------------


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


def band_rows(n_rows: int, band=None):
    """(row0, rows, clamp_lo, clamp_hi) of the rows a box sum produces and
    the rows it may read. Without ``band``: every row, edge-replicated at
    the image's top and bottom. With ``band = (halo, is_top, is_bot)`` the
    ``n_rows`` rows are a tile's ``rows = n_rows - 2*halo`` core rows with
    ``halo`` real rows from each neighbour tile; a tile at the image's top
    (bottom) edge replicates its first (last) core row's cost instead, as
    the single-device box sum does (K1's ``band_halo``,
    ``openvo_tpu/ops/sgbm_pallas.py:240-247``)."""
    if band is None:
        return 0, n_rows, 0, n_rows - 1
    halo, is_top, is_bot = band
    rows = n_rows - 2 * halo
    if rows < 1:
        raise ValueError(f"a band of {n_rows} rows has no core rows with a "
                         f"halo of {halo}")
    return (halo, rows, halo if is_top else 0,
            halo + rows - 1 if is_bot else n_rows - 1)


def block_sum(vol, block_size: int, band=None):
    """block_size x block_size box sum of an (..., H, W, D) volume with
    edge-replicated borders (see :func:`band_rows` for ``band``), in the
    JAX package's order: rows i = 0..bs-1 added one at a time, then columns
    the same way. Exact for integers; the JAX package's rounding for
    float32. The adds are elementwise, so a batch of frames gives each
    its own call's bits."""
    row0, rows, lo, hi = band_rows(vol.shape[-3], band)
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


def cost_volume_f32(lp, rp, min_disp: int, num_disp: int, block_size: int,
                    cap: int, bf16: bool, band=None):
    """Box-summed (H, W, D) float32 cost on the x1 grid, for configurations
    without an int16 sentinel: the BT cost without doubling or truncation,
    4*cap where a sample falls outside the image, then :func:`block_sum` in
    float32 (``openvo_tpu/ops/sgbm.py:156-171``). Plain PyTorch on every
    device, as the JAX package leaves this stage to XLA. A (B, H, W) batch
    gives (B, H, W, D) in one pass, each frame its own call's bits."""
    cost = _bt_cost(lp, rp, min_disp, num_disp, bf16)
    cost = torch.where(torch.isnan(cost), float(4 * cap), cost)
    return block_sum(cost, block_size, band)


# ---------------------------------------------------------------------------
# plain versions: the scans
# ---------------------------------------------------------------------------


def _shift_x(prev, k: int, fill):
    """prev at axis-0 offset -k (``_shift_x`` of the JAX package), ``fill``
    where that falls outside."""
    if k == 0:
        return prev
    pad = torch.full_like(prev[:1], fill)
    if k == 1:
        return torch.cat([pad, prev[:-1]])
    return torch.cat([prev[1:], pad])


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
    """L of one direction along axis 0 of an (N0, N1, D) cost on the x2
    grid, as int32; the previous L is read at axis-1 offset ``-xshift``
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
                L[0] = fresh_start(c[0])
            elif xshift == -1:
                L[-1] = fresh_start(c[-1])
        out[i] = L
        prev = L
    return (out, prev) if return_carry else out


def scan_f32(cost, xshift: int, p1: float, p2: float, reverse: bool = False,
             init=None, return_carry: bool = False):
    """:func:`sgm_scan` on the x1 grid in float32, literally the JAX
    package's ``_scan_dirs`` for one direction: the carry starts at 1e9
    (or ``init``), the shift fills 1e9, and the first L of a line is
    ``(c + 1e9) - 1e9`` by the recurrence itself."""
    out = torch.empty_like(cost, dtype=torch.float32)
    prev = (torch.full(cost.shape[1:], BIG_F, dtype=torch.float32,
                       device=cost.device) if init is None else init)
    for i in _rows(cost.shape[0], reverse):
        prev = _step(_shift_x(prev, xshift, BIG_F), cost[i], float(p1),
                     float(p2), BIG_F)
        out[i] = prev
    return (out, prev) if return_carry else out


def cost_hsweep_plain(lp, rp, min_disp, num_disp, block_size, sentinel, p1,
                      p2, bf16, band=None):
    """Plain H1: (C (rows, W, D) int16, s1 (rows, W, D) int32 forward
    horizontal L), penalties on the x2 grid; ``band`` as
    :func:`band_rows`. (B, H, W) images give (B, rows, W, D) volumes."""
    if lp.ndim == 3:
        return _over_frames(
            lambda a, b: cost_hsweep_plain(a, b, min_disp, num_disp,
                                           block_size, sentinel, p1, p2,
                                           bf16, band), lp, rp)
    C = block_sum(bt_cost_volume2(lp, rp, min_disp, num_disp, sentinel,
                                  bf16), block_size, band).to(torch.int16)
    s1 = sgm_scan(C.transpose(0, 1), 0, p1, p2).transpose(0, 1)
    return C, s1.contiguous()


def vsweep_plain(C, p1, p2, diagonals: bool, down: bool = True,
                 up: bool = False, init_carry=None,
                 return_carry: bool = False):
    """Plain H2: the sum of the vertical scans (with both diagonals if
    ``diagonals``) walked top-down (``down``) and bottom-up (``up``).

    Over int16 C (x2 grid): int32, in any order. Over float32 C (x1 grid):
    one direction of travel, summed in the JAX package's order
    ``(L(0) + L(+1)) + L(-1)``.

    ``init_carry`` (ndirs, W, D) seeds the first row walked of each
    direction; ``return_carry`` also returns the (ndirs, W, D) L of the last
    row walked. Both need one direction of travel. A (B, H, W, D) C runs
    frame by frame, with (B, ndirs, W, D) carries."""
    if C.ndim == 4:
        return _over_frames(
            lambda c, i: vsweep_plain(c, p1, p2, diagonals, down, up, i,
                                      return_carry), C, init_carry)
    xshifts = XSHIFTS if diagonals else (0,)
    ways = [False] * down + [True] * up
    _check_ways(C, ways, init_carry is not None or return_carry)
    scan = sgm_scan if C.dtype == torch.int16 else scan_f32
    total, carry = None, []
    for reverse in ways:
        for j, k in enumerate(xshifts):
            L, last = scan(C, k, p1, p2, reverse,
                           None if init_carry is None else init_carry[j],
                           return_carry=True)
            total = L if total is None else total + L
            carry.append(last)
    return (total, torch.stack(carry)) if return_carry else total


def _rows_of(C):
    """C's rows as one (rows, W, D) volume: a batch's frames one after
    another (each row is a scan line of its own)."""
    return C.reshape((-1,) + tuple(C.shape[-2:]))


def hsweep_plain(C, p1, p2):
    """Plain H5: L of the left-to-right scan of an (H, W, D) (or
    (B, H, W, D)) float32 cost."""
    L = scan_f32(_rows_of(C).transpose(0, 1), 0, p1, p2).transpose(0, 1)
    return L.reshape(C.shape).contiguous()


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


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_C_TYPES = (torch.int16, torch.float32)


def cost_hsweep(lp, rp, min_disp: int, num_disp: int, block_size: int,
                sentinel: int, p1: int, p2: int, bf16: bool, band=None):
    """H1, replacing ``sgbm_pallas.cost_sweep_fused`` (K1), with its
    ``band_halo`` variant. (C int16, s1 int32) for float32 prefiltered
    images; penalties on the x2 grid; ``bf16`` rounds the cost arithmetic
    as :func:`bt_cost_volume2`. With ``band = (halo, is_top, is_bot)`` the
    images are a row tile with ``halo`` rows from each neighbour and only
    the core rows are returned (:func:`band_rows`).

    Two kernels on the stream, counted as one launch. ``bt_box`` computes C
    in parallel over tiles of 16 rows x 32 columns x 32 disparities: each
    input row's bfloat16-rounded samples and half-sample envelopes once per
    pixel of the tile, each BT cost once per (input row, column, disparity)
    from them, the vertical and horizontal box sums as sliding integer sums
    in shared memory. ``hwalk`` then walks each row with one warp, lane l
    holding disparities VPL*l .. VPL*l + VPL - 1 (VPL = D/32 rounded up to
    a power of two): the neighbours d +- 1 by one shuffle each way, min L'
    by one ``redux.sync``. No block barrier is on the walk, and no load or
    store of a volume: lane 0 fetches 16 columns of C at a time into the
    warp's shared memory with one TMA bulk copy (an mbarrier signals it,
    two chunks in flight) and sends the chunk's s1 back with another. What
    bounds H1 on the H100 is that walk's dependency chain over W (a
    latency: a KITTI frame gives one warp to each SM quarter it reaches)
    plus ``bt_box``'s arithmetic and shared-memory traffic; the byte floor
    is 8 bytes per volume element (C written and read back, s1 written). A
    band reads its halo rows where the JAX kernel's edge fix-up replaces
    their cost, so it costs no extra pass; its walk takes as long as the
    whole image's. D not a multiple of 8, or above 256, takes a walk with
    scalar loads at 32 disparities a lane (correct, several times
    slower); every D of :class:`SGBMParams` up to 256 takes the ring.

    (B, H, W) images (each with the same ``band``) give (B, rows, W, D)
    volumes from one launch of each kernel: ``bt_box`` takes the frame
    from its grid's z (a box sum never crosses a frame's edge), ``hwalk``
    walks the B * rows rows."""
    dev = device_of(lp, rp)
    if dev.type == "cpu":
        return cost_hsweep_plain(lp, rp, min_disp, num_disp, block_size,
                                 sentinel, p1, p2, bf16, band)
    lead, (H, W) = _lead(lp, 2, "lp")
    check_cuda_input(lp, torch.float32, lead + (H, W), "lp")
    check_cuda_input(rp, torch.float32, lead + (H, W), "rp")
    _check_disparities(num_disp)
    row0, rows, lo, hi = band_rows(H, band)
    lib = _build.library()
    C = torch.empty(lead + (rows, W, num_disp), dtype=torch.int16,
                    device=dev)
    s1 = torch.empty(lead + (rows, W, num_disp), dtype=torch.int32,
                     device=dev)
    err = lib.ovo_cost_hsweep(lp.data_ptr(), rp.data_ptr(), C.data_ptr(),
                              s1.data_ptr(), H, W, num_disp, min_disp,
                              block_size // 2, sentinel, p1, p2, int(bf16),
                              row0, rows, lo, hi, _count(lead),
                              stream_handle(dev))
    cost_hsweep.launches += 1
    _build.check_launch(err, "cost_hsweep")
    return C, s1


# The trio walk (csrc/sgbm_trio.cu) takes D a multiple of 8 up to 128 (a
# lane's slots in 16-byte rows, 4 slots a lane at most), frames of at most
# TRIO_MAX_W columns (each block walks a strip of them; the card holds every
# strip of a frame at once), and at least TRIO_MIN_FRAMES frames a launch:
# a row takes it 3-5 us however few frames share it, so on the H100 1 or 2
# KITTI frames take longer than in vsweep_kernel (1.18 and 0.59 ms a frame
# against 0.46 and 0.46) and 3 frames shorter (0.40 against 0.48;
# tools/probe_warp_walk.cu, PERF.md section 6).
TRIO_MAX_D = 128
TRIO_MAX_W = 4096
TRIO_MIN_FRAMES = 3


def vsweep_design(dtype, diagonals: bool, carry: bool, aligned: bool,
                  D: int, W: int, frames: int) -> str:
    """Which H2 kernel a :func:`vsweep` call over a C of ``dtype`` takes:
    ``"trio"``, the row-synchronous walk of the trio into the sum
    (``csrc/sgbm_trio.cu``, one launch a direction of travel), for int16 C
    with both diagonals, no carry in or out, 16-byte aligned volumes, D a
    multiple of 8 up to :data:`TRIO_MAX_D`, W up to :data:`TRIO_MAX_W` and
    at least :data:`TRIO_MIN_FRAMES` frames; else ``"lines"``, a warp a
    scan line (``csrc/sgbm.cu``'s ``vsweep_kernel``): the straight line
    alone, the carries, float32 C, a single frame and the scalar
    fallback."""
    if (dtype == torch.int16 and diagonals and not carry and aligned
            and D % 8 == 0 and D <= TRIO_MAX_D and W <= TRIO_MAX_W
            and frames >= TRIO_MIN_FRAMES):
        return "trio"
    return "lines"


_TRIO_SCRATCH_BYTES = {}


def _trio_scratch(dev):
    """A scratch of the trio walk's own for one call on ``dev``, from the
    caching allocator on the current stream: the launch zeroes the part it
    uses on that stream before its blocks hand their edges on through it, so
    calls on other streams, in flight at once, share none of it."""
    n = _TRIO_SCRATCH_BYTES.get(dev)
    if n is None:
        with torch.cuda.device(dev):
            n = _TRIO_SCRATCH_BYTES[dev] = (
                _build.library().ovo_vsweep_trio_scratch())
    return torch.empty(n, dtype=torch.uint8, device=dev)


def vsweep(C, p1: int, p2: int, diagonals: bool, down: bool = True,
           up: bool = False, init_carry=None, return_carry: bool = False,
           acc=None):
    """H2, replacing ``sgbm_pallas.sweep_v`` (K2) in its forward and reverse,
    one- and three-direction variants, with and without its carry in and
    out. The sum of the vertical scans (straight, or with both diagonals)
    walked top-down and/or bottom-up, as :func:`vsweep_plain`: int32 over
    int16 C (5 paths take the top-down trio, 8 paths both trios, 4 paths
    the straight line both ways), float32 over float32 C (one direction of
    travel a call).

    ``init_carry``/``return_carry`` continue a sweep across a row-tile
    boundary (``parallel/tiling.py``): a line that starts on the first row
    walked reads its previous L from ``init_carry[dir][x - dx]`` where that
    column exists, and the line that reaches the last row walked at column
    x writes its L to ``carry[dir][x]``. Over int16 C, ``acc`` (an int32
    (H, W, D) volume) takes the sum in place and is returned, as the row
    tiles add their bottom-up sweep into the top-down one (exact in any
    order); over float32 C the partials stay apart for the sum order.

    Two kernels, chosen by :func:`vsweep_design` from the call. The sum is
    a zeroed int32 volume, or ``acc``: the SGBM passes H1's s1, so no
    zeroed volume is written.

    - The trio walk (``csrc/sgbm_trio.cu``; trace counter
      ``ovo.vsweep_trio``, one a launch) over int16 C, one launch a
      direction of travel (8 paths: down, then up), each on a scratch of its
      own that it zeroes on its stream (about 1 MB for 8 KITTI frames). A frame's width is cut
      into strips, a block a strip, and the block walks the rows in the
      order of travel: each warp holds its 5 columns' previous-row L of
      all three directions in registers (lane l holds disparities VPL*l ..
      VPL*l + VPL - 1: the neighbours d +- 1 by one shuffle each way, min L'
      by one ``redux.sync``, 15 lines a row interleaved), takes the
      diagonals' L across warps through shared memory and across blocks
      through L2, and adds each pixel's three L into the sum. C and the
      sum's rows come into a ring in shared memory by TMA bulk copies and
      the summed rows go back the same way, so it moves the trio's bytes
      once (C read, the sum read and written: 0.178 ms a KITTI frame at
      3.35 TB/s; 0.209 measured at 8 and 16 frames) and no atomic. A
      cooperative launch: every block resident, frames beyond what the
      card holds walked in turn.
    - A warp a scan line (``csrc/sgbm.cu``'s ``vsweep_kernel``; trace
      counter ``ovo.vsweep``), every line of every direction asked for in
      one launch over int16 C, one launch per direction over float32 C,
      with :func:`cost_hsweep`'s lane layout and no block barrier or
      shared memory on the walk's chain; each warp loads its line's pixels
      4 steps ahead into registers with vector loads. Over int16 C each
      warp stages 4 pixels' L in shared memory and sends each with one
      bulk reduce-add (``cp.reduce.async.bulk .add.s32``) into L2, exact
      in any order: those adds bound it (the top-down trio of a KITTI frame
      about 0.46 ms, its walk with plain stores 0.26). Over float32 C the
      launches go in the order 0, +1, -1: every pixel lies on one line of a
      direction, so each step sets ``acc = acc + L`` (``acc = L`` in the
      first launch), which keeps the JAX package's float32 sum order;
      bound by the three launches' reads and writes of the sum.

    A (B, H, W, D) C (with (B, ndirs, W, D) carries and a (B, H, W, D)
    ``acc``) walks every frame in each launch: a frame moves only base
    offsets."""
    dev = device_of(*(t for t in (C, init_carry, acc) if t is not None))
    _check_ways(C, [False] * down + [True] * up,
                init_carry is not None or return_carry)
    if acc is not None and C.dtype != torch.int16:
        raise ValueError("vsweep: acc takes the sum over int16 C only; over "
                         "float32 C the partials stay apart")
    if dev.type == "cpu":
        out = vsweep_plain(C, p1, p2, diagonals, down, up, init_carry,
                           return_carry)
        if acc is None:
            return out
        sv, carry = out if return_carry else (out, None)
        acc += sv
        return (acc, carry) if return_carry else acc
    lead, (H, W, D) = _lead(C, 3, "C")
    _check_cost(C, lead + (H, W, D))
    _check_disparities(D)
    nd = len(XSHIFTS) if diagonals else 1
    acc_t = torch.int32 if C.dtype == torch.int16 else torch.float32
    if init_carry is not None:
        check_cuda_input(init_carry, acc_t, lead + (nd, W, D), "init_carry")
    if acc is not None:
        check_cuda_input(acc, acc_t, lead + (H, W, D), "acc")
        sv = acc
    elif C.dtype == torch.float32:    # the first launch sets it
        sv = torch.empty(lead + (H, W, D), dtype=acc_t, device=dev)
    else:        # the walks add into it
        sv = torch.zeros(lead + (H, W, D), dtype=acc_t, device=dev)
    carry_io = init_carry is not None or return_carry
    aligned = C.data_ptr() % 16 == 0 and sv.data_ptr() % 16 == 0
    if vsweep_design(C.dtype, diagonals, carry_io, aligned, D, W,
                     _count(lead)) == "trio":
        return _vsweep_trio(C, sv, p1, p2, down, up)
    return _vsweep_lines(C, sv, p1, p2, nd, down, up, init_carry,
                         return_carry)


def _vsweep_trio(C, sv, p1: int, p2: int, down: bool, up: bool):
    """The trio walk over int16 C into sv (checked by :func:`vsweep`), one
    launch a direction of travel."""
    lead, (H, W, D) = _lead(C, 3, "C")
    dev = C.device
    lib = _build.library()
    scratch = _trio_scratch(dev)
    for way_up in [False] * down + [True] * up:
        err = lib.ovo_vsweep_trio(C.data_ptr(), sv.data_ptr(), H, W, D, p1,
                                  p2, int(way_up), _count(lead),
                                  scratch.data_ptr(), scratch.numel(),
                                  stream_handle(dev))
        vsweep.launches += 1
        trace.count("ovo.vsweep_trio")
        _build.check_launch(err, "vsweep (trio)")
    return sv


def _vsweep_lines(C, sv, p1: int, p2: int, nd: int, down: bool, up: bool,
                  init_carry=None, return_carry: bool = False):
    """A warp a scan line over C into sv (checked by :func:`vsweep`), with
    the carries: one launch over int16 C, one a direction over float32 C
    (the first setting sv)."""
    lead, (H, W, D) = _lead(C, 3, "C")
    dev = C.device
    lib = _build.library()
    f32 = C.dtype == torch.float32
    carry = (torch.empty(lead + (nd, W, D), dtype=sv.dtype, device=dev)
             if return_carry else None)

    def carry_ptr(t, j):   # direction j's carry of the first frame
        return None if t is None else t.select(-3, j).data_ptr()

    # (first direction, number of directions) of each launch: every
    # direction in one over int16 C, one launch each over float32 C
    for j0, n in [(j, 1) for j in range(nd)] if f32 else [(0, nd)]:
        err = lib.ovo_vsweep(
            C.data_ptr(), int(f32), sv.data_ptr(), H, W, D, p1, p2, j0, n,
            int(down), int(up), int(f32 and j0 == 0),
            carry_ptr(init_carry, j0), carry_ptr(carry, j0), _count(lead),
            nd * W * D, stream_handle(dev))
        vsweep.launches += 1
        trace.count("ovo.vsweep")
        _build.check_launch(err, "vsweep")
    return (sv, carry) if return_carry else sv


def hsweep(C, p1: int, p2: int):
    """H5, replacing ``sgbm_pallas.sweep_h`` (K6) in its forward form: L of
    the left-to-right scan over an (H, W, D) float32 cost on the x1 grid,
    float32 (:func:`hsweep_plain`); the configurations without an int16
    sentinel take their forward partial s1 from it.

    :func:`cost_hsweep`'s warp walk (``hwalk``) over float32 C: one warp
    per row, the lane layout, shuffles and ``redux.sync`` of that walk, and
    its TMA ring (lane 0 fetches 16 columns of C at a time into the warp's
    shared memory and sends the chunk's L back, three chunks in flight).
    The walk starts from a previous L of 1e9 everywhere and min L' = 1e9,
    as the JAX carry, so its first L is ``(c + 1e9) - 1e9``. Bound by the
    walk's dependency chain over W (376 rows give one warp to each SM
    quarter they reach: about 0.18 ms at KITTI size on the H100, 1.2x the
    0.14 ms its 8 bytes per volume element take). A (B, H, W, D) C is
    B * H rows of one launch."""
    dev = device_of(C)
    if dev.type == "cpu":
        return hsweep_plain(C, p1, p2)
    lead, (H, W, D) = _lead(C, 3, "C")
    check_cuda_input(C, torch.float32, lead + (H, W, D), "C")
    _check_disparities(D)
    lib = _build.library()
    out = torch.empty(C.shape, dtype=torch.float32, device=dev)
    err = lib.ovo_hsweep(C.data_ptr(), out.data_ptr(), _count(lead) * H, W,
                         D, p1, p2, stream_handle(dev))
    hsweep.launches += 1
    _build.check_launch(err, "hsweep")
    return out


def hsweep_wta_lr(C, s1, sv, p1: int, p2: int, min_disp: int,
                  uniqueness: int, disp12: int, svu=None):
    """H3, replacing ``sgbm_pallas.sweep_hw_wta`` (K3) and, over float32 C,
    ``sweep_h_wta`` (K7), with ``lr_lookup`` (K4) and the post-pass
    between them. Final (H, W) int16 disparity x16, as
    :func:`hsweep_wta_lr_plain`; ``svu`` is the bottom-up vertical partial
    where it is kept apart for the float32 sum order. Over int16 C, H2 adds
    the vertical sums into s1 (:func:`vsweep`'s ``acc``), ``sv`` is None
    and the walk reads two volumes.

    One warp per row, walking x right to left with the lane layout of
    :func:`cost_hsweep`'s walk: the reverse scan (neighbours by shuffles,
    min L' by one ``redux.sync``), S, the argmin with the lowest d (over
    int16 C one redux of the int32 key ``S * D + d``; over float32 C one
    redux of S's bits, a non-negative float's bits keeping its order, and
    one of the lowest d holding it), the uniqueness vote by ``__any_sync``,
    and the right-view argmin bestR(xr) = argmin_d S(xr + d, d) as a
    register shift of packed keys (slot d holds diagonal x - d's running
    min; one shuffle moves it to slot d - 1 at the next column, so slot 0
    holds diagonal x complete). No block barrier is on the walk, and the
    loads leave its chain: over float32 C lane 0 fetches chunks of C, s1,
    sv (and svu) into the warp's shared memory with TMA bulk copies and
    mbarriers, three chunks in flight; over int16 C each lane loads its
    slots 8 columns ahead into registers (each the faster on the H100).
    best, bestR, min S and S(best -+ 1) for the row stay in the warp's
    shared memory; an epilogue in the same kernel does subpixel, the LR
    lookup bestR[x - best] (K4 as a shared-memory read), uniqueness and the
    invalid encoding. Bound by the walk's chain over W and the issue slots
    of the column's reductions, vote and shuffles beside it (a latency: a
    KITTI frame gives one warp to each SM quarter it reaches); it reads 6
    bytes per volume element over int16 C, 12 over float32 C, 4 more with
    ``svu``. (B, H, W, D) volumes give (B, H, W) from one launch: the
    B * H rows are walked as one volume's."""
    named = [(n, t) for n, t in (("s1", s1), ("sv", sv), ("svu", svu))
             if t is not None]
    dev = device_of(C, *(t for _, t in named))
    if C.dtype == torch.int16 and (sv is not None or svu is not None):
        raise ValueError("hsweep_wta_lr: over int16 C the vertical sums are "
                         "added into s1 (vsweep's acc), not passed apart")
    if sv is None and C.dtype == torch.float32:
        raise ValueError("hsweep_wta_lr: over float32 C the vertical sum "
                         "sv stays apart from s1 for the sum order")
    if dev.type == "cpu":
        return hsweep_wta_lr_plain(C, s1, sv, p1, p2, min_disp, uniqueness,
                                   disp12, svu)
    lead, (H, W, D) = _lead(C, 3, "C")
    _check_cost(C, lead + (H, W, D))
    acc_t = torch.int32 if C.dtype == torch.int16 else torch.float32
    for name, t in named:
        check_cuda_input(t, acc_t, lead + (H, W, D), name)
    _check_disparities(D)
    lib = _build.library()
    out = torch.empty(lead + (H, W), dtype=torch.int16, device=dev)
    err = lib.ovo_hsweep_wta_lr(C.data_ptr(), int(C.dtype == torch.float32),
                                s1.data_ptr(),
                                None if sv is None else sv.data_ptr(),
                                None if svu is None else svu.data_ptr(),
                                out.data_ptr(), _count(lead) * H, W, D, p1,
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


def _lead(t, frame_dims: int, name: str):
    """(batch shape, frame shape) of ``t``: a frame of ``frame_dims``
    axes, or a batch of them on one leading axis."""
    if t.ndim not in (frame_dims, frame_dims + 1):
        raise ValueError(f"{name}: {t.ndim} axes, expected {frame_dims} or "
                         f"{frame_dims + 1} (a leading frame axis)")
    return tuple(t.shape[:-frame_dims]), tuple(t.shape[-frame_dims:])


def _count(lead) -> int:
    """Frames in a batch shape: 1 without a frame axis."""
    return lead[0] if lead else 1


def _check_ways(C, ways, carry: bool) -> None:
    if not ways:
        raise ValueError("vsweep: no direction of travel")
    if len(ways) > 1 and (carry or C.dtype == torch.float32):
        raise ValueError("vsweep: a carry, or float32 C, takes one direction "
                         "of travel a call")


def _check_cost(C, shape) -> None:
    if C.dtype not in _C_TYPES:
        raise TypeError(f"C: dtype {C.dtype}, expected int16 or float32")
    check_cuda_input(C, C.dtype, shape, "C")


def _check_disparities(D: int) -> None:
    # the warp walks hold at most 32 disparities a lane
    if not 1 <= D <= 1024:
        raise ValueError(f"the CUDA SGBM kernels need num_disparities in "
                         f"[1, 1024], got {D}")
