"""Disparity -> 3D reprojection via the Q matrix, PyTorch port of
``openvo_tpu/geometry/reproject.py``.

[X, Y, Z, W]^T = Q @ [x, y, d, 1]^T, output (X/W, Y/W, Z/W). The divide is
plain IEEE division on purpose: W == 0 gives inf, as cv2.reprojectImageTo3D.
"""

from __future__ import annotations

import torch


def reproject_image_to_3d(disparity, Q):
    """(H, W) float disparity -> (H, W, 3) float32 points; (B, H, W) ->
    (B, H, W, 3)."""
    H, W = disparity.shape[-2:]
    dev = disparity.device
    Q = torch.as_tensor(Q, dtype=torch.float32, device=dev)
    d = disparity.to(torch.float32)
    x = torch.arange(W, dtype=torch.float32, device=dev).expand(d.shape)
    y = torch.arange(H, dtype=torch.float32,
                     device=dev)[:, None].expand(d.shape)
    v = torch.stack([x, y, d, torch.ones_like(d)], dim=-1)
    out = v @ Q.T
    return out[..., :3] / out[..., 3:4]
