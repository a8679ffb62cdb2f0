"""Inf-aware renormalizing bilinear sampler for 3D point images, PyTorch
port of ``openvo_tpu/ops/interpolate.py``.

Of the four neighbours of (x, y), only those inside the image and with no
infinite channel contribute; the bilinear weights are renormalized over
them (num / den), and with none the result is 0/0 = NaN, which the pose
fit's NaN gate relies on.
"""

from __future__ import annotations

import torch


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
