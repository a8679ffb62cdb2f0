"""Image primitives: grayscale, Sobel, box filter, antialiased bilinear
resize.

PyTorch port of ``openvo_tpu/ops/image.py``. Each function keeps the JAX
version's arithmetic order (shifted-add sums in the same sequence) so that
float32 results agree with it on the CPU.

XLA fuses a float32 ``a * b + c`` into one fused multiply-add (a single
rounding) where the product feeds the add directly, taking the first
operand's product when both are products. PyTorch rounds the product
first. :func:`fma` reproduces the fused form where the port must match the
JAX package bit for bit (Harris response, window blur, GET_VALUE rotation,
remap weights).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def fma(a, b, c):
    """float32 ``a * b + c`` with one rounding. The float64 product of two
    float32 values is exact, so only the sum rounds twice (to float64,
    then float32), which differs from a true fused multiply-add only when
    the float64 sum lands exactly on a float32 rounding tie."""
    a = a.to(torch.float64) if torch.is_tensor(a) else float(a)
    return (a * b.to(torch.float64) + c.to(torch.float64)).to(torch.float32)


def bgr_to_gray(img):
    """BGR (H, W, 3) -> gray (H, W): 0.114 B + 0.587 G + 0.299 R, rounded
    and clipped for integer input."""
    w = torch.tensor([0.114, 0.587, 0.299], dtype=torch.float32,
                     device=img.device)
    g = img.to(torch.float32) @ w
    if not torch.is_floating_point(img):
        return torch.clamp(torch.round(g), 0, 255).to(img.dtype)
    return g


def _pad2d(img, ry, rx, mode):
    """Pad the last two axes of a (..., H, W) tensor by (ry, rx) on both
    sides; ``mode`` as ``F.pad`` ("constant" pads with 0)."""
    lead = img.shape[:-2]
    x = img.reshape((-1, 1) + img.shape[-2:])
    x = F.pad(x, (rx, rx, ry, ry), mode=mode)
    return x.reshape(lead + x.shape[-2:])


def sobel_xy(img):
    """3x3 Sobel dx, dy of (..., H, W) images with REFLECT_101 borders
    (float32)."""
    x = _pad2d(img.to(torch.float32), 1, 1, "reflect")
    H, W = img.shape[-2:]

    def sh(dy, dx):
        return x[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    dx = ((sh(-1, 1) + 2 * sh(0, 1) + sh(1, 1))
          - (sh(-1, -1) + 2 * sh(0, -1) + sh(1, -1)))
    dy = ((sh(1, -1) + 2 * sh(1, 0) + sh(1, 1))
          - (sh(-1, -1) + 2 * sh(-1, 0) + sh(-1, 1)))
    return dx, dy


def box_filter(img, ksize: int):
    """ksize x ksize unnormalized box sum of (..., H, W) images, same-size
    output, zero padding; horizontal then vertical shifted adds."""
    r = ksize // 2
    x = _pad2d(img.to(torch.float32), r, r, "constant")
    H, W = img.shape[-2:]
    h = x[..., :, 0:W]
    for i in range(1, ksize):
        h = h + x[..., :, i:i + W]
    out = h[..., 0:H, :]
    for i in range(1, ksize):
        out = out + h[..., i:i + H, :]
    return out


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV-compatible 1D Gaussian (cv2.getGaussianKernel semantics)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = (ksize - 1) / 2.0
    x = np.arange(ksize) - r
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 triangle-kernel weights of an antialiased
    linear resize, built the way ``jax.image.scale_and_translate`` builds
    them: when downscaling the kernel is widened by the inverse scale (the
    antialiasing that ``F.interpolate`` does not do), each output column is
    normalised by its weight sum, and samples outside the input get 0."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, f32(1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) * inv_scale - f32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
         * (f32(1.0) / kernel_scale))
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.zeros((1, out_size), f32)
    for i in range(in_size):
        total = total + w[i:i + 1]
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps, w / np.where(total != 0, total, f32(1)),
                 f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def resize_bilinear(img, out_h: int, out_w: int):
    """Antialiased bilinear resize with half-pixel centres, as
    ``jax.image.resize(img, (out_h, out_w), "linear")``: two float32
    contractions with the triangle-kernel weight matrices, rows first.

    (B, H, W) images take the same two contractions frame by frame (the
    weights uploaded once): a batched matmul may pick another kernel and
    round otherwise, and one ulp reorders Harris near-ties."""
    img = img.to(torch.float32)
    H, W = img.shape[-2:]
    wh = ww = None
    if out_h != H:
        wh = torch.from_numpy(resize_weights(H, out_h)).to(img.device).T
    if out_w != W:
        ww = torch.from_numpy(resize_weights(W, out_w)).to(img.device)

    def one(out):
        if wh is not None:
            out = wh @ out
        if ww is not None:
            out = out @ ww
        return out

    if img.ndim == 2:
        return one(img)
    return torch.stack([one(f) for f in img])
