"""Masked rigid 3D-3D alignment (Kabsch, rotation forced) and the outlier
pass's residual, PyTorch port of ``openvo_tpu/pose/kabsch.py``.

R from the SVD of the masked cross-covariance with the determinant-sign
fix, t = mean(dst) - R mean(src). With fewer than 3 valid points the result
is all NaN on purpose, and so is the fit of a NaN or inf valid row: the
odometer's NaN gate catches it. The fit's 3x3 SVD is a fixed count of
Jacobi sweeps that never reads the host, so the odometer's step can be
captured as one CUDA graph; :func:`svd` (``torch.linalg.svd``, whose
convergence check syncs on the card) stays for RANSAC and the five-point
solver.
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


JACOBI_SWEEPS = 5   # cyclic sweeps of the rotations (0, 1), (0, 2), (1, 2)


def _rotation_3x3(H):
    """The rotation of the Kabsch fit from the finite (..., 3, 3) float64
    cross-covariance ``H = U S V^T``: ``V diag(1, 1, d) U^T`` with d =
    sign(det(V U^T)), the sign going to the least singular value's pair.

    One-sided (Hestenes) Jacobi: JACOBI_SWEEPS cyclic sweeps of plane
    rotations make the columns of ``A = H V`` orthogonal, V being their
    product (a proper rotation); a fixed count, no data-dependent exit, no
    host check. Then ``u_i = a_i / |a_i|``: the column of least norm is
    moved last by a cyclic shift (V stays proper) and its u replaced by
    ``u_1 x u_2``, so U is proper, d = 1 and R = V U^T. The sign flip is
    folded into u_3, which also holds where that singular value is 0 (a
    planar or 3-point cloud). Only correctly rounded elementwise
    operations (+, -, *, /, sqrt, copysign): each member of a batch gets
    its own call's bits, on the CPU and the card alike."""
    lead = H.shape[:-2]
    eye = torch.eye(3, dtype=H.dtype, device=H.device).expand(lead + (3, 3))
    cols = list(torch.cat([H, eye], dim=-2).unbind(-1))   # A over V: (.., 6)
    for _ in range(JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            x, y = cols[p], cols[q]
            xy = torch.stack([x[..., :3], y[..., :3]], dim=-1)   # (..., 3, 2)
            g = xy[..., :, None] * xy[..., None, :]
            g = g[..., 0, :, :] + g[..., 1, :, :] + g[..., 2, :, :]
            # t, the tangent of the smaller angle that zeroes the columns'
            # dot product: 2g / (d + sign(d) sqrt(d^2 + 4g^2)); 0 for 0/0
            d = g[..., 1, 1] - g[..., 0, 0]
            two_g = g[..., 0, 1] + g[..., 0, 1]
            r = torch.sqrt(d * d + two_g * two_g)
            t = torch.nan_to_num(two_g / (d + torch.copysign(r, d)), nan=0.0)
            c = torch.sqrt(1.0 + t * t).reciprocal()
            s = (c * t)[..., None]
            c = c[..., None]
            cols[p], cols[q] = c * x - s * y, s * x + c * y
    M = torch.stack(cols, dim=-1)
    A, V = M[..., :3, :], M[..., 3:, :]
    sq = A * A
    norm = torch.sqrt(sq[..., 0, :] + sq[..., 1, :] + sq[..., 2, :])
    order = (norm.argmin(-1, keepdim=True)
             + torch.arange(1, 4, device=H.device)) % 3
    idx = order[..., None, :].expand(lead + (3, 3))
    A, V, norm = A.gather(-1, idx), V.gather(-1, idx), norm.gather(-1, order)
    # u_1, u_2; where a column is 0 (H = 0), V's column, as LAPACK's I
    u = torch.where(norm[..., None, :2] > 0,
                    A[..., :2] / torch.where(norm > 0, norm,
                                             1.0)[..., None, :2],
                    V[..., :2])
    u1, u2 = u[..., 0], u[..., 1]

    def cyc(v, k):   # (v[k], v[k+1], v[k+2]) mod 3, without an index upload
        return torch.roll(v, -k, dims=-1)

    u3 = cyc(u1, 1) * cyc(u2, 2) - cyc(u1, 2) * cyc(u2, 1)
    return V @ torch.stack([u1, u2, u3], dim=-2)


def kabsch(src, dst, mask):
    """Best-fit rigid (4, 4) float32 transform mapping ``src`` (N, 3) ->
    ``dst`` over the rows where ``mask`` holds. Invalid rows may hold
    anything (inf, NaN): they are zeroed before the reduction; NaNs in
    valid rows poison the fit on purpose. A batch, (B, N, 3) with a
    (B, N) mask, gives (B, 4, 4).

    The fit runs in float64 and rounds once to float32 at the end: the
    products of float32 values are exact and the sums round near 1e-16, so
    a batched call gives each member its own call's float32 bits whatever
    order the batched sums and products take. The 3x3 SVD is
    :func:`_rotation_3x3`'s Jacobi sweeps, which make no host sync (the
    fit runs inside a captured CUDA graph); a non-finite H gives NaN, as
    LAPACK under JAX."""
    w = mask.to(torch.float64)[..., None]
    n = torch.clamp_min(w.sum(-2), 1.0)
    src_c = torch.where(w > 0, src.to(torch.float64), 0.0)
    dst_c = torch.where(w > 0, dst.to(torch.float64), 0.0)
    mu_s = src_c.sum(-2) / n
    mu_d = dst_c.sum(-2) / n
    X = (src_c - mu_s[..., None, :]) * w
    Y = (dst_c - mu_d[..., None, :]) * w
    H = X.transpose(-1, -2) @ Y
    finite = torch.isfinite(H).all(dim=-1).all(dim=-1)[..., None, None]
    R = torch.where(finite, _rotation_3x3(torch.where(finite, H, 0.0)),
                    float("nan"))
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
