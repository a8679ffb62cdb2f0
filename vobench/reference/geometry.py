"""Geometry of the plain reference: reprojection of a disparity to 3D, the
Kabsch fit (float64 sums over a fixed pairwise tree, one-sided Jacobi
for the 3x3 rotation) and the rotation angle of the motion gate.

Frozen copy of the plain versions in ``openvo_tpu_torch/pose/kabsch.py``,
``geometry/se3.py`` and ``geometry/reproject.py`` of the commit that defined the benchmark: plain PyTorch, no kernel, no import of
the program, so that a later change to the program cannot move it.
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


def rotation_magnitude(R):
    """Rotation angle arccos((tr(R) - 1) / 2), clipped against fp drift."""
    tr = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    c = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    return torch.arccos(c)


def rt_to_T(R, t):
    """Stack R (..., 3, 3) and t (..., 3) into (..., 4, 4) homogeneous
    transforms."""
    t = t.reshape(R.shape[:-2] + (3, 1))
    top = torch.cat([R, t], dim=-1)
    bottom = R.new_zeros(R.shape[:-2] + (1, 4))
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


JACOBI_SWEEPS = 5   # H10: cyclic sweeps of the rotations (0, 1), (0, 2), (1, 2)


def _chain_sum(p):
    """p[..., 0] + p[..., 1] + ... added left to right, as H10 and H11 add."""
    acc = p[..., 0]
    for k in range(1, p.shape[-1]):
        acc = acc + p[..., k]
    return acc


def _tree_sum(x):
    """The sums over axis 1 of (B, N, Q) ``x`` as H10 adds them: a fixed
    pairwise tree over N padded to a power of two with -0.0 (which leaves
    every sum as it is, so a wider padding gives the same bits), element i
    plus element i + h, h halving down to 1. (B, Q)."""
    width = 1 << max(x.shape[1] - 1, 0).bit_length()
    if width > x.shape[1]:
        pad = x.new_full((x.shape[0], width - x.shape[1], x.shape[2]), -0.0)
        x = torch.cat([x, pad], dim=1)
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] + x[:, h:]
    return x[:, 0]


def _rotate(x, y, g_pp, g_qq, g_pq):
    """(c x - s y, s x + c y): the plane rotation of the columns ``x``,
    ``y`` (..., L) that zeroes their dot product ``g_pq``, with t = s / c
    the tangent of the smaller such angle, 2g / (d + sign(d) sqrt(d^2 +
    4g^2)) for d = g_qq - g_pp, and 0 for 0/0."""
    d = g_qq - g_pp
    two_g = g_pq + g_pq
    r = torch.sqrt(d * d + two_g * two_g)
    t = torch.nan_to_num(two_g / (d + torch.copysign(r, d)), nan=0.0)
    c = torch.sqrt(1.0 + t * t).reciprocal()
    s = (c * t)[..., None]
    c = c[..., None]
    return c * x - s * y, s * x + c * y


def _left_3x3(A, V, norm):
    """U^T's rows (..., 3, 3) of a 3x3 one-sided Jacobi: ``u_i = a_i /
    |a_i|`` for the first two columns of A (V's column where a norm is 0,
    as LAPACK's I for H = 0), ``u_3 = u_1 x u_2``."""
    u = torch.where(norm[..., None, :2] > 0,
                    A[..., :2] / torch.where(norm > 0, norm,
                                             1.0)[..., None, :2],
                    V[..., :2])
    u1, u2 = u[..., 0], u[..., 1]

    def cyc(v, k):   # (v[k], v[k+1], v[k+2]) mod 3, without an index upload
        return torch.roll(v, -k, dims=-1)

    u3 = cyc(u1, 1) * cyc(u2, 2) - cyc(u1, 2) * cyc(u2, 1)
    return torch.stack([u1, u2, u3], dim=-2)


def rotation_3x3_plain(H):
    """H10's plain version: the factors (V, U^T) of the Kabsch rotation
    ``R = V U^T`` of finite (..., 3, 3) float64 cross-covariances ``H = U
    S V^T``, each (..., 3, 3); R = V diag(1, 1, d) U^T with d = sign(det(V
    U^T)), the sign going to the least singular value's pair.

    One-sided (Hestenes) Jacobi: JACOBI_SWEEPS cyclic sweeps of plane
    rotations make the columns of ``A = H V`` orthogonal, V being their
    product (a proper rotation); a fixed count, no data-dependent exit, no
    host check. Then ``u_i = a_i / |a_i|``: the column of least norm is
    moved last by a cyclic shift (V stays proper) and its u replaced by
    ``u_1 x u_2``, so U is proper, d = 1 and R = V U^T. The sign flip is
    folded into u_3, which also holds where that singular value is 0 (a
    planar or 3-point cloud). Only elementwise operations (+, -, *, /,
    sqrt, copysign): each member of a batch gets its own call's bits. On
    the card every one is correctly rounded, as in H10; torch's float64
    sqrt on the CPU is an ulp off on about 0.7% of values."""
    lead = H.shape[:-2]
    eye = torch.eye(3, dtype=H.dtype, device=H.device).expand(lead + (3, 3))
    cols = list(torch.cat([H, eye], dim=-2).unbind(-1))   # A over V: (.., 6)
    for _ in range(JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            x, y = cols[p], cols[q]
            xy = torch.stack([x[..., :3], y[..., :3]], dim=-1)   # (..., 3, 2)
            g = _chain_sum((xy[..., :, None] * xy[..., None, :]).movedim(
                -3, -1))                                       # (..., 2, 2)
            cols[p], cols[q] = _rotate(x, y, g[..., 0, 0], g[..., 1, 1],
                                       g[..., 0, 1])
    M = torch.stack(cols, dim=-1)
    A, V = M[..., :3, :], M[..., 3:, :]
    norm = torch.sqrt(_chain_sum((A * A).transpose(-1, -2)))
    order = (norm.argmin(-1, keepdim=True)
             + torch.arange(1, 4, device=H.device)) % 3
    idx = order[..., None, :].expand(lead + (3, 3))
    A, V, norm = A.gather(-1, idx), V.gather(-1, idx), norm.gather(-1, order)
    return V, _left_3x3(A, V, norm)


def cross_covariance(src, dst, mask):
    """(H, mu_s, mu_d, count) of the Kabsch fit of (B, N, 3) clouds in
    float64 as H10 computes them: the valid count, the masked sums of the
    valid rows (invalid rows 0), the means (over max(count, 1)), then H =
    X^T Y of the centred valid rows (invalid rows 0), every sum a
    :func:`_tree_sum` over the points. H (B, 3, 3), count (B,) int64."""
    src = src.to(torch.float64)
    dst = dst.to(torch.float64)
    valid = mask[..., None]
    count = mask.to(torch.int64).sum(-1)
    sums = _tree_sum(torch.where(valid, torch.cat([src, dst], -1), 0.0))
    mu = sums / count.clamp_min(1).to(torch.float64)[:, None]
    mu_s, mu_d = mu[:, :3], mu[:, 3:]
    X = torch.where(valid, src - mu_s[:, None], 0.0)
    Y = torch.where(valid, dst - mu_d[:, None], 0.0)
    P = (X[..., :, None] * Y[..., None, :]).flatten(-2)   # X_k Y_l at 3k + l
    return _tree_sum(P).reshape(-1, 3, 3), mu_s, mu_d, count


def kabsch_fit_plain(src, dst, mask):
    """H10's plain version: the (B, 4, 4) float32 Kabsch fits of ``src``
    to ``dst`` (B, N, 3) float32 over the rows where ``mask`` (B, N) holds.
    :func:`cross_covariance`, then where H is finite
    :func:`rotation_3x3_plain`'s factors, R = V U^T and t = mu_d - R mu_s,
    each entry a left-to-right chain, rounded once to float32; R and t NaN
    where H is not, and the whole T NaN where fewer than 3 rows are
    valid."""
    H, mu_s, mu_d, count = cross_covariance(src, dst, mask)
    finite = torch.isfinite(H).all(-1).all(-1)
    V, Ut = rotation_3x3_plain(torch.where(finite[:, None, None], H, 0.0))
    R = _chain_sum(V[..., :, None, :] * Ut.transpose(-1, -2)[..., None, :, :])
    R = torch.where(finite[:, None, None], R, float("nan"))
    t = mu_d - _chain_sum(R * mu_s[:, None, :])
    T = rt_to_T(R, t).to(torch.float32)
    return torch.where((count < 3)[:, None, None], float("nan"), T)

