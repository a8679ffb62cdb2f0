"""Brute-force Hamming matching (kNN-2 + Lowe ratio test), PyTorch port of
``openvo_tpu/ops/hamming.py``.

hamming(a, b) = sum(a) + sum(b) - 2 * dot(a, b) over 0/1 bit vectors, so
the (N1, N2) distance matrix is one float32 matmul of unpacked bits: every
partial sum is an integer <= 256, exact in float32 (and without TF32, which
the port turns off). Argmin ties go to the lowest index, as in JAX.
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
