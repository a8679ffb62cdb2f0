"""Semi-Global Block Matching (SGBM) disparity, PyTorch port of
``openvo_tpu/ops/sgbm.py``.

Contract (as ``cv2.StereoSGBM.compute`` and the JAX package): int16
disparity on the x16 grid, invalid = (minDisparity - 1) * 16. Stages:
x-Sobel prefilter clipped to preFilterCap, Birchfield-Tomasi cost over D
disparities, blockSize^2 box sum, 4-, 5- or 8-path SGM aggregation, WTA
with uniqueness ratio, parabolic subpixel, left-right check
(disp12MaxDiff), and the optional speckle filter.

The volume stages run as kernels (``ops/sgbm_cuda.py``); a CPU tensor takes
their plain versions, a CUDA tensor the kernels. Both reproduce the JAX
package's CPU path bit for bit, which is the tier-1 oracle, including its
bfloat16 cost arithmetic for ``2*preFilterCap <= 127`` on non-integer
images (a distorting camera's remap). Per frame:

- with an int16 sentinel for (blockSize, preFilterCap): H1 (cost, box sum,
  left-to-right scan s1) -> H2 (the vertical scans of the path count,
  added into s1: exact in integers) -> H3 over int16 costs (right-to-left
  scan, WTA, checks);
- without one (blockSize >= 13 at preFilterCap 63, or preFilterCap > 327
  at blockSize 5): the float32 cost volume and box sum in plain PyTorch,
  as the JAX package leaves them to XLA -> H5 (left-to-right scan) -> H2
  (top-down, and bottom-up apart for 4 and 8 paths) -> H3, all in float32
  on the x1 grid in the JAX package's order of operations, so fractional
  images give JAX's bits here too.

The speckle filter's labelling is H7 (``ops/speckle_cuda.py``) on the
card and plain PyTorch on the CPU (:func:`speckle_filter`). Every stage
takes a (B, H, W) batch of frames as well and runs it in one pass.
``NotImplementedError`` is raised, on every device, only where the packed
int32 argmin key of H3 over int16 costs could overflow.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from openvo_tpu_torch.config import SGBMParams
from openvo_tpu_torch.ops import sgbm_cuda, speckle_cuda


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
        speckle_filter.syncs += 1
        if torch.equal(lu, lv):
            break
        labels = labels.scatter_reduce(0, torch.maximum(lu, lv),
                                       torch.minimum(lu, lv), "amin")
        for _ in range(jumps):
            labels = labels[labels]
    size = torch.bincount(labels, minlength=total)
    keep = valid & (size[labels] > window).view(disp.shape)
    return labels.to(torch.int32).view(disp.shape), keep


@torch.library.custom_op("openvo_torch::speckle_keep", mutates_args=(),
                         device_types="cpu")
def _speckle_keep(disp: torch.Tensor, valid: torch.Tensor, max_diff: int,
                  window: int) -> tuple[torch.Tensor, torch.Tensor]:
    return speckle_keep_plain(disp, valid, max_diff, window)


@_speckle_keep.register_kernel("cuda")
def _(disp, valid, max_diff, window):
    return speckle_cuda.speckle_keep(disp.contiguous(), valid.contiguous(),
                                     max_diff, window)


@_speckle_keep.register_fake
def _(disp, valid, max_diff, window):
    return (disp.new_empty(disp.shape, dtype=torch.int32),
            valid.new_empty(disp.shape))


def speckle_filter(disp16, valid, params: SGBMParams):
    """The valid mask after speckle rejection (``cv2.filterSpeckles``
    semantics, the JAX package's ``_speckle_filter``): 4-connected
    components of valid pixels whose x16 disparities differ by at most
    16*speckleRange are invalidated when they hold <= speckleWindowSize
    pixels; invalid pixels are singletons. Takes (H, W) or a (B, H, W)
    batch, as the JAX package's batched core ``_speckle_filter_batched``.

    Any exact labelling gives the JAX package's components, whose min-scan
    labelling runs to convergence. The operator ``openvo_torch::
    speckle_keep`` labels them: H7 (``ops/speckle_cuda.py``, union-find in
    a fixed number of launches, no host read) on the card, its plain
    version :func:`speckle_keep_plain` on the CPU, and under ``make_fx``'s
    fake mode a node of the traced graph."""
    return torch.ops.openvo_torch.speckle_keep(
        disp16, valid, 16 * params.speckle_range,
        params.speckle_window_size)[1]


speckle_filter.syncs = 0


def cost_and_forward(lp, rp, params: SGBMParams, cap: int, band=None):
    """(C, s1, p1, p2) of prefiltered images: the box-summed cost and the
    left-to-right partial, with the penalties on C's grid. With an int16
    sentinel: H1 on the x2 grid (int16 C, int32 s1); without one: the
    float32 cost volume and H5 on the x1 grid. ``band`` as
    ``sgbm_cuda.band_rows``."""
    sent = int16_sentinel(params.block_size, cap)
    bf16 = 2 * cap <= 127
    args = (lp, rp, params.min_disparity, params.num_disparities,
            params.block_size)
    if sent is not None:
        _check_envelope(params, params.block_size ** 2 * sent)
        p1, p2 = 2 * params.effective_p1, 2 * params.effective_p2
        C, s1 = sgbm_cuda.cost_hsweep(*args, sent, p1, p2, bf16, band)
        return C, s1, p1, p2
    p1, p2 = params.effective_p1, params.effective_p2
    C = sgbm_cuda.cost_volume_f32(*args, cap, bf16, band)
    return C, sgbm_cuda.hsweep(C, p1, p2), p1, p2


def vertical(C, p1: int, p2: int, num_paths: int, acc=None):
    """(sv, svu) for ``num_paths``: the top-down partial (with the bottom-up
    one, over int16 C, in the same launch) and the bottom-up partial kept
    apart over float32 C (else None), whose sum order H3 keeps. Over int16
    C, ``acc`` (H1's s1) takes the sum in place and is returned as sv."""
    diagonals = num_paths != 4
    if num_paths == 5 or C.dtype == torch.int16:
        return sgbm_cuda.vsweep(C, p1, p2, diagonals, up=num_paths != 5,
                                acc=acc), None
    return (sgbm_cuda.vsweep(C, p1, p2, diagonals),
            sgbm_cuda.vsweep(C, p1, p2, diagonals, down=False, up=True))


def sgbm_disparity16(left, right, params: SGBMParams):
    """Full SGBM pipeline -> (H, W) int16 disparity x16 on the images'
    device; invalid = (minDisparity - 1) * 16. A (B, H, W) batch runs each
    kernel, the plain stages and the speckle filter once for the
    batch and gives (B, H, W), each frame's disparity bit for bit."""
    if left.device != right.device:
        raise ValueError(f"device mismatch: {left.device} vs {right.device}")
    cap = max(params.pre_filter_cap, 15) | 1
    lp = prefilter_xsobel(left, cap)
    rp = prefilter_xsobel(right, cap)
    C, s1, p1, p2 = cost_and_forward(lp, rp, params, cap)
    if C.dtype == torch.int16:   # exact in integers: H2 adds into s1
        vertical(C, p1, p2, params.num_paths, acc=s1)
        sv, svu = None, None
    else:
        sv, svu = vertical(C, p1, p2, params.num_paths)
    out = sgbm_cuda.hsweep_wta_lr(C, s1, sv, p1, p2, params.min_disparity,
                                  params.uniqueness_ratio,
                                  params.disp12_max_diff, svu)
    if params.speckle_window_size > 0 and params.speckle_range > 0:
        invalid = (params.min_disparity - 1) * 16
        valid = out != invalid
        out = torch.where(speckle_filter(out, valid, params), out, invalid)
    return out


def sgbm_disparity(left, right, params: SGBMParams):
    """Float disparity in pixels: int16 grid / 16."""
    return sgbm_disparity16(left, right, params).to(torch.float32) / 16.0
