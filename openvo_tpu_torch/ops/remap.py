"""Undistort/rectify remap with bilinear interpolation, PyTorch port of
``openvo_tpu/ops/remap.py``: :func:`remap_bilinear` is its gather form as
JAX runs it eagerly, op by op (the camera's ``undistort_rectify_left`` and
``_right``), :func:`remap_u8` the same rounded back to uint8, and
:func:`make_remap` what the JAX camera's compiled program computes, whose
maps are constants of it (both the gather and the bounded roll+select
forms give those bits).

Border behaviour matches ``cv2.remap``'s BORDER_CONSTANT(0): a neighbour
outside the source contributes 0 with its bilinear weight.

The JAX module's other names, and their counterparts here:

- ``remap_bilinear_bounded`` (roll + select, for the TPU's vector unit):
  :func:`make_remap`, a gather that gives the same bits under jit;
- ``make_remap``'s choice between the two forms and its limits
  ``MAX_BOUNDED_DX``, ``_DY``, ``_AREA``: none, :func:`make_remap` has
  one form.
"""

from __future__ import annotations

import numpy as np
import torch

from openvo_tpu_torch.ops.image import fma


def remap_bilinear(src, map_x, map_y):
    """Sample ``src`` (H, W) or (H, W, C) at float coords (map_x, map_y);
    returns (map_h, map_w[, C]) float32. As the JAX package runs it
    eagerly: every product and sum rounded on its own, in the order
    ``p00 (1-wx) (1-wy) + p01 wx (1-wy) + p10 (1-wx) wy + p11 wx wy``."""
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    H, W, C = src.shape
    flat = src.to(torch.float32).reshape(H * W, C)

    x = map_x.to(torch.float32)
    y = map_y.to(torch.float32)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = flat[idx.reshape(-1)].reshape(idx.shape + (C,))
        return torch.where(valid[..., None], vals, 0.0)

    p00 = tap(y0i, x0i)
    p01 = tap(y0i, x0i + 1)
    p10 = tap(y0i + 1, x0i)
    p11 = tap(y0i + 1, x0i + 1)

    wx = fx[..., None]
    wy = fy[..., None]
    out = (p00 * (1 - wx) * (1 - wy) + p01 * wx * (1 - wy)
           + p10 * (1 - wx) * wy + p11 * wx * wy)
    return out[..., 0] if squeeze else out


def remap_u8(src, map_x, map_y):
    """:func:`remap_bilinear`, rounded half to even and clipped back to
    uint8 (``cv2.remap`` on uint8 input rounds to nearest)."""
    out = remap_bilinear(src, map_x, map_y)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def displacement_bounds(map_x, map_y):
    """Integer bounds (dx_min, dx_max, dy_min, dy_max) of how far a remap
    field's source samples stray from the identity (floor(map) - pixel
    index; non-finite entries count as 0). A setup-time helper on the
    host: the maps are calibration constants."""
    mx, my = (m.detach().cpu().numpy() if torch.is_tensor(m)
              else np.asarray(m) for m in (map_x, map_y))
    h, w = mx.shape
    dx = np.floor(mx) - np.arange(w, dtype=np.float32)[None, :]
    dy = np.floor(my) - np.arange(h, dtype=np.float32)[:, None]
    dx = np.where(np.isfinite(dx), dx, 0)
    dy = np.where(np.isfinite(dy), dy, 0)
    return (int(dx.min()), int(dx.max()), int(dy.min()), int(dy.max()))


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
