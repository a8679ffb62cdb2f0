"""Masked rigid 3D-3D alignment (Kabsch, rotation forced) and the outlier
pass's residual, PyTorch port of ``openvo_tpu/pose/kabsch.py``.

R from the SVD of the masked cross-covariance with the determinant-sign
fix, t = mean(dst) - R mean(src). With fewer than 3 valid points the result
is all NaN on purpose, and so is the fit of a NaN or inf valid row: the
odometer's NaN gate catches it.
"""

from __future__ import annotations

import torch

from openvo_tpu_torch.geometry.se3 import rt_to_T
from openvo_tpu_torch.ops.image import fma


def transform_points(T, pts):
    """Apply the 4x4 ``T`` to (N, 3) points."""
    return pts @ T[:3, :3].T + T[:3, 3]


def row_norm(v):
    """Euclidean norm of each row of (..., n) float32 ``v``, with XLA:CPU's
    order: a chain of fused multiply-adds over the components, then sqrt."""
    acc = v[..., 0] * v[..., 0]
    for i in range(1, v.shape[-1]):
        acc = fma(v[..., i], v[..., i], acc)
    return torch.sqrt(acc)


def svd(a, full_matrices=True):
    """``torch.linalg.svd`` of (..., m, n) that, like LAPACK under JAX,
    returns NaN for a matrix holding a non-finite value instead of raising:
    the SVD runs on a finite stand-in and NaN goes where LAPACK puts it."""
    finite = torch.isfinite(a).all(dim=-1).all(dim=-1)
    U, S, Vh = torch.linalg.svd(torch.where(finite[..., None, None], a, 0.0),
                                full_matrices=full_matrices)
    nan = float("nan")
    return (torch.where(finite[..., None, None], U, nan),
            torch.where(finite[..., None], S, nan),
            torch.where(finite[..., None, None], Vh, nan))


def kabsch(src, dst, mask):
    """Best-fit rigid (4, 4) float32 transform mapping ``src`` (N, 3) ->
    ``dst`` over the rows where ``mask`` holds. Invalid rows may hold
    anything (inf, NaN): they are zeroed before the reduction; NaNs in
    valid rows poison the fit on purpose. A batch, (B, N, 3) with a
    (B, N) mask, gives (B, 4, 4) from one batched 3x3 SVD.

    The fit runs in float64 and rounds once to float32 at the end: the
    products of float32 values are exact and the sums round near 1e-16, so
    a batched call gives each member its own call's float32 bits whatever
    order the batched sums, products and SVD take."""
    w = mask.to(torch.float64)[..., None]
    n = torch.clamp_min(w.sum(-2), 1.0)
    src_c = torch.where(w > 0, src.to(torch.float64), 0.0)
    dst_c = torch.where(w > 0, dst.to(torch.float64), 0.0)
    mu_s = src_c.sum(-2) / n
    mu_d = dst_c.sum(-2) / n
    X = (src_c - mu_s[..., None, :]) * w
    Y = (dst_c - mu_d[..., None, :]) * w
    H = X.transpose(-1, -2) @ Y
    U, _, Vt = svd(H)   # NaN in H: NaN in R and t, as LAPACK under JAX
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    one = torch.ones_like(d)
    R = V @ torch.diag_embed(torch.stack([one, one, d], -1)) @ Ut
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    few = (mask.sum(-1) < 3)[..., None, None]
    return torch.where(few, float("nan"), rt_to_T(R, t).to(torch.float32))


def residuals_relative(T, src, dst, mask):
    """The outlier pass's residual ||h_dst - T h_src|| / ||h_dst|| over
    homogeneous 4-vectors; inf where ``mask`` is False. (B, N, 3) points
    with (B, 4, 4) transforms give (B, N). ``T h_src`` is XLA:CPU's dot,
    bit for bit: the four products added in ascending order without
    fusing, elementwise, so a batch gives each member its own call's
    bits."""
    ones = torch.ones(src.shape[:-1] + (1,), dtype=src.dtype,
                      device=src.device)
    hs = torch.cat([src, ones], dim=-1)
    hd = torch.cat([dst, ones], dim=-1)
    pred = hs[..., 0, None] * T[..., None, :, 0]
    for k in range(1, 4):
        pred = pred + hs[..., k, None] * T[..., None, :, k]
    err = row_norm(hd - pred) / row_norm(hd)
    return torch.where(mask, err, float("inf"))
