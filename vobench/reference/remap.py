"""Rectification of the plain reference: bilinear remap by constant maps.

Frozen copy of the plain versions in ``openvo_tpu_torch/ops/remap.py`` of
the commit that defined the benchmark: plain PyTorch, no kernel, no import of
the program, so that a later change to the program cannot move it.
"""

from __future__ import annotations

import torch

from vobench.reference.image import fma


def make_remap(map_x, map_y):
    """The remap of one constant (H, W) map pair onto (H, W) sources, as the
    JAX camera's compiled program computes it: XLA folds each bilinear
    weight (1-fx)(1-fy), fx(1-fy), (1-fx)fy, fx*fy into one rounded float32
    product and contracts the sum into multiply-adds. Fractional maps (a
    distorting camera) give other bits than :func:`remap_bilinear`; the
    taps' indices and weights are computed here once."""
    H, W = map_x.shape
    x = map_x.to(torch.float32)
    y = map_y.to(torch.float32)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    taps = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yi, xi = y0i + dy, x0i + dx
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        taps.append((valid, yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)))
    w = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)

    def remap(src):
        """(H, W) sources, or (B, H, W): every frame by the same maps."""
        if tuple(src.shape[-2:]) != (H, W) or src.ndim > 3:
            raise ValueError(f"remap: source shape {tuple(src.shape)}, "
                             f"maps {(H, W)}")
        flat = src.to(torch.float32).flatten(-2)
        p = [torch.where(valid, flat[..., idx], 0.0) for valid, idx in taps]
        out = fma(p[0], w[0], p[1] * w[1])
        out = fma(p[2], w[2], out)
        return fma(p[3], w[3], out)

    return remap

