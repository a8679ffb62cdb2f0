"""Matching of the plain reference: brute-force Hamming kNN-2 with Lowe's
ratio test, and the inf-aware bilinear sampler of 3D images.

Frozen copy of the plain versions in ``openvo_tpu_torch/ops/hamming.py`` and
``ops/interpolate.py`` of the commit that defined the benchmark: plain PyTorch, no kernel, no import of
the program, so that a later change to the program cannot move it.
"""

from __future__ import annotations

import torch


BIG = 1 << 30  # "infinite" distance for masked rows/cols


def unpack_bits(desc_u8):
    """(..., N, 32) uint8 packed descriptors -> (..., N, 256) int8 bits,
    LSB-first."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc_u8.device)
    bits = (desc_u8[..., None] >> shifts) & 1
    return bits.flatten(-2).to(torch.int8)


def pack_bits(bits):
    """(..., N, 8*B) 0/1 bits -> (..., N, B) uint8, LSB-first per byte."""
    b = bits.unflatten(-1, (-1, 8)).to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    return (b << shifts).sum(-1).to(torch.uint8)


def hamming_distance_matrix(desc1, desc2, mask1=None, mask2=None):
    """(..., N1, N2) int32 Hamming distances of (..., N, 32) descriptors (a
    leading batch axis is one batched matmul, exact as any other); masked
    rows/cols get BIG."""
    a = unpack_bits(desc1).to(torch.float32)
    b = unpack_bits(desc2).to(torch.float32)
    dot = (a @ b.transpose(-1, -2)).to(torch.int32)
    sa = a.sum(-1).to(torch.int32)
    sb = b.sum(-1).to(torch.int32)
    d = sa[..., :, None] + sb[..., None, :] - 2 * dot
    if mask1 is not None:
        d = torch.where(mask1[..., :, None], d, BIG)
    if mask2 is not None:
        d = torch.where(mask2[..., None, :], d, BIG)
    return d


def knn2(desc1, desc2, mask1=None, mask2=None):
    """Best and second-best train match of every query:
    (d1, i1, d2, i2), each (..., N1) int32."""
    d = hamming_distance_matrix(desc1, desc2, mask1, mask2)
    i1 = d.argmin(-1)
    d1 = d.gather(-1, i1[..., None])[..., 0]
    onehot = torch.arange(d.shape[-1], device=d.device) == i1[..., None]
    d_masked = torch.where(onehot, BIG, d)
    i2 = d_masked.argmin(-1)
    d2 = d_masked.gather(-1, i2[..., None])[..., 0]
    return d1, i1.to(torch.int32), d2, i2.to(torch.int32)


def ratio_test_match(desc1, desc2, ratio, mask1=None, mask2=None):
    """kNN(k=2) + Lowe ratio test: query i matches iff d1 < ratio * d2
    (strict). Returns (train_idx (..., N1) int32, match_mask (..., N1)
    bool)."""
    d1, i1, d2, _ = knn2(desc1, desc2, mask1, mask2)
    ok = d1.to(torch.float32) < ratio * d2.to(torch.float32)
    ok = ok & (d1 < BIG)
    if mask1 is not None:
        ok = ok & mask1
    return i1, ok


def bilinear_sample_3d(img3d, xs, ys):
    """Sample (H, W, 3) ``img3d`` at N subpixel positions -> (N, 3); a
    batch, (B, H, W, 3) images at (B, N) positions, gives (B, N, 3)."""
    H, W, C = img3d.shape[-3:]
    flat = img3d.reshape(img3d.shape[:-3] + (H * W, C))
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    rx = (xs - x0)[..., None]
    ry = (ys - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(yi, xi, in_bounds):
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = torch.gather(flat, -2, idx[..., None].expand(idx.shape + (C,)))
        # only +/-inf excludes a neighbour; NaNs pass through into the sum
        noinf = ~torch.isinf(vals).any(-1)
        return vals, (noinf & in_bounds)[..., None]

    in10 = (x0i + 1) < W
    in01 = (y0i + 1) < H
    in11 = in10 & in01
    always = torch.ones_like(in10)

    p00, ok00 = tap(y0i, x0i, always)
    p10, ok10 = tap(y0i, x0i + 1, in10)
    p01, ok01 = tap(y0i + 1, x0i, in01)
    p11, ok11 = tap(y0i + 1, x0i + 1, in11)

    w00 = (1 - rx) * (1 - ry)
    w10 = rx * (1 - ry)
    w01 = (1 - rx) * ry
    w11 = rx * ry

    num = (torch.where(ok00, w00 * p00, 0.0)
           + torch.where(ok10, w10 * p10, 0.0)
           + torch.where(ok01, w01 * p01, 0.0)
           + torch.where(ok11, w11 * p11, 0.0))
    den = (torch.where(ok00, w00, 0.0)
           + torch.where(ok10, w10, 0.0)
           + torch.where(ok01, w01, 0.0)
           + torch.where(ok11, w11, 0.0))
    return num / den

