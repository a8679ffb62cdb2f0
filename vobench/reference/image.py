"""Image primitives of the plain reference: Sobel, box sum, fused
multiply-add, antialiased bilinear resize.

Frozen copy of the plain versions in ``openvo_tpu_torch/ops/image.py`` of
the commit that defined the benchmark: plain PyTorch, no kernel, no import of
the program, so that a later change to the program cannot move it.
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


_SUM_LOOP = (352, 32)


_NORM_LOOP = (88, 8)


def _fma64(a, b, c):
    """float32 ``a * b + c`` rounded once (as :func:`fma`, on numpy)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _tree_sum(w):
    """Sum over axis 0 as XLA:CPU reduces it: windows of 32 rows, the input
    padded evenly at both ends to a multiple of 32, each window added in
    order from 0; again over the partials while more than 32 are left;
    then the partials in order."""
    f32 = np.float32
    while w.shape[0] > 32:
        n = w.shape[0]
        lo = (-(-n // 32) * 32 - n) // 2
        parts = []
        for start in range(-lo, n, 32):
            acc = np.zeros(w.shape[1:], f32)
            for r in range(max(start, 0), min(start + 32, n)):
                acc = acc + w[r]
            parts.append(acc)
        w = np.stack(parts)
    acc = np.zeros(w.shape[1:], f32)
    for r in range(w.shape[0]):
        acc = acc + w[r]
    return acc


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 triangle-kernel weights of an antialiased
    linear resize, bit-equal to those ``jax.image.resize`` uses inside jit
    on XLA:CPU (``jax.image.scale_and_translate``'s recipe): when
    downscaling the kernel is widened by the inverse scale (the
    antialiasing that ``F.interpolate`` does not do), each output column is
    normalised by its weight sum, and samples outside the input get 0.
    The rounding follows XLA's two fusions (``_SUM_LOOP``, ``_NORM_LOOP``)
    and its reduction (:func:`_tree_sum`)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    inv_kernel = f32(1.0) / np.maximum(inv_scale, f32(1.0))
    centre = np.arange(out_size, dtype=f32) + f32(0.5)
    rows = np.arange(in_size, dtype=f32)[:, None]

    def weights(loop_min, step):
        looped = np.arange(out_size) < (
            out_size // step * step if out_size >= loop_min else 0)
        sample = np.where(looped, _fma64(centre, inv_scale, f32(-0.5)),
                          centre * inv_scale + f32(-0.5))
        x = np.abs(sample[None, :] - rows)
        w = np.where(looped[None, :], f32(1.0) - x * inv_kernel,
                     _fma64(-x, inv_kernel, f32(1.0)))
        return sample, np.maximum(w, f32(0.0))

    total = _tree_sum(weights(*_SUM_LOOP)[1])
    sample, w = weights(*_NORM_LOOP)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps, w / np.where(total != 0, total, f32(1)),
                 f32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


@functools.lru_cache(maxsize=64)
def resize_taps(in_size: int, out_size: int):
    """The band of :func:`resize_weights` (in_size, out_size): per output
    its first input index and its count of taps (int32 (out_size,) each)
    and the taps' weights in input order, float32 (out_size, T), zero past
    each count, T the most taps of any output (at least 1). The triangle
    kernel's support is contiguous, so the band holds every nonzero
    weight."""
    w = resize_weights(in_size, out_size)
    nz = w != 0
    count = nz.sum(0)
    first = np.where(count > 0, nz.argmax(0), 0)
    last = np.where(count > 0, in_size - 1 - nz[::-1].argmax(0), first - 1)
    n = last - first + 1
    taps = max(int(n.max()), 1)
    t = np.arange(taps)
    idx = np.minimum(first[:, None] + t, in_size - 1)
    band = np.where(t < n[:, None], w[idx, np.arange(out_size)[:, None]],
                    np.float32(0))
    return (first.astype(np.int32), n.astype(np.int32),
            band.astype(np.float32))


def band_chain(x, first, count, taps, dim: int):
    """The contraction of ``x`` (..., H, W) along ``dim`` (-2: rows, -1:
    columns) with one band of weights per output, as one chain of
    multiply-adds per output in input order from 0, each rounded once
    (:func:`fma`): ``first``, ``count`` (n_out,) int and ``taps`` (n_out,
    T) float32 tensors on x's device (:func:`resize_taps`)."""
    size = x.shape[dim]
    if dim == -2:
        out = x.new_zeros(x.shape[:-2] + (first.shape[0], x.shape[-1]))
    else:
        out = x.new_zeros(x.shape[:-1] + (first.shape[0],))
    for t in range(taps.shape[1]):
        src = x.index_select(dim, (first.to(torch.int64) + t).clamp(
            max=size - 1))
        w, on = taps[:, t], t < count
        if dim == -2:
            w, on = w[:, None], on[:, None]
        out = torch.where(on, fma(w, src, out), out)
    return out


def resize_bilinear(img, out_h: int, out_w: int):
    """Antialiased bilinear resize with half-pixel centres, as
    ``jax.image.resize(img, (out_h, out_w), "linear")``: two float32
    contractions with the triangle-kernel weights, rows first, each an
    ascending chain of multiply-adds per output (:func:`band_chain`). The
    weights are XLA's bit for bit and so is the rows' product (XLA:CPU's
    order); the columns' is XLA's Eigen kernel, whose order moves with the
    shape, so levels differ from JAX's in float32 ulps. A fixed order: a
    batch of images, (B, H, W), gives each frame's bits, and the card's
    kernel H6 (``ops/orb_cuda.resize_levels``) the same bits again."""
    img = img.to(torch.float32)
    H, W = img.shape[-2:]
    for n_in, n_out, dim in ((H, out_h, -2), (W, out_w, -1)):
        if n_out != n_in:
            first, count, taps = (torch.from_numpy(a).to(img.device)
                                  for a in resize_taps(n_in, n_out))
            img = band_chain(img, first, count, taps, dim)
    return img

