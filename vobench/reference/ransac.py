"""Five-point RANSAC for the essential matrix and recoverPose of the plain
reference, one frame's hypotheses at a time:

- the samples: ``jax.random.choice(key, n, (iters, 5), p=mask / sum)``
  given its uniforms, ``searchsorted(cumsum(p), cumsum(p)[-1] * (1 -
  u))`` with XLA:CPU's blocked cumulative sum (index 0 where no row is
  valid);
- each sample's up to 10 candidates (``fivepoint.py``), scored by MSAC
  (the truncated Sampson sum); the 8 lowest, ties to the lower index; of
  those within a margin of the best, the one with the most cheirality
  support; then two guarded least-squares refits over the inliers (the
  SVD of the float64 Gram), each kept where its MSAC sum is at most 1.5
  times and its support at least 0.7 times the current one's;
- recoverPose: the four (R, t) of E, the one with the most points in
  front of both cameras (midpoint triangulation) over the inliers.

Frozen copy of the plain versions in ``openvo_tpu_torch/pose/ransac.py``
(on the card's SVD route) of the commit that added the monocular cell:
plain PyTorch, no kernel, no import of the program, so that a later change
to the program cannot move it.

Where this departs from OpenCV's ``findEssentialMat(RANSAC, prob 0.999,
threshold 1 px)`` + ``recoverPose``: a fixed count of samples (64 for 256
iterations), no adaptive termination; MSAC's truncated Sampson sum in
place of the count of inliers, with a margin and the cheirality support
deciding among near-ties; the two refits over the inliers (OpenCV returns
the best minimal E); the Sampson threshold (1 px over the mean focal
length)^2 in normalized coordinates.

``low=True`` is the control: the five-point solver (``fivepoint.py``),
the Sampson distances and the MSAC sums held in bfloat16, the SVDs'
Jacobi sweeps in float32.
"""

from __future__ import annotations

import torch

from vobench.reference.fivepoint import candidates, epipolar_rows, held
from vobench.reference.svd import det3, svd
from vobench.reference.util import device_constant

SCAN_BASE = 16   # XLA:CPU's blocked cumulative sum: blocks of 16
TOP_CANDIDATES = 8
REFIT_ROUNDS = 2


def cumsum_blocked(p):
    """float32 inclusive cumulative sum of 1-D ``p``: a sequential sum
    inside blocks of 16, each block offset by the (recursive) cumulative
    sum of the blocks before it."""
    n = p.shape[0]
    if n <= SCAN_BASE:
        out = [p[0]]
        for i in range(1, n):
            out.append(out[-1] + p[i])
        return torch.stack(out)
    nb = -(-n // SCAN_BASE)
    blocks = torch.nn.functional.pad(p, (0, nb * SCAN_BASE - n)).view(
        nb, SCAN_BASE)
    cols = [blocks[:, 0]]
    for i in range(1, SCAN_BASE):
        cols.append(cols[-1] + blocks[:, i])
    inner = torch.stack(cols, dim=1)
    before = torch.cat([inner.new_zeros(1),
                        cumsum_blocked(inner[:, -1])[:-1]])
    return (inner + before[:, None]).reshape(-1)[:n]


def sample_indices(u, mask):
    """(iters, k) indices of valid rows, with replacement, from the
    uniforms ``u`` (iters, k)."""
    p = mask.to(torch.float32)
    p = p / p.sum().clamp_min(1.0)
    cum = cumsum_blocked(p)
    r = cum[-1] * (1.0 - u)
    return torch.searchsorted(cum, r.reshape(-1).contiguous()).reshape(u.shape)


def sampson_error(E, x1, x2, low: bool = False):
    """Squared Sampson distances (..., N) of normalized correspondences
    (N, 2) under essential matrices E (..., 3, 3)."""
    ones = torch.ones_like(x1[:, :1])
    h1 = torch.cat([x1, ones], dim=1)
    h2 = torch.cat([x2, ones], dim=1)
    Ex1 = h1 @ E.transpose(-1, -2)
    Etx2 = h2 @ E
    num = (h2 * Ex1).sum(-1) ** 2
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2
           + Etx2[..., 1] ** 2)
    return held(num / den.clamp_min(1e-12), low)


def project_essential(E, low: bool = False):
    """The nearest matrix with the essential spectrum (1, 1, 0)."""
    u, _, v = svd(E, low)
    return (u * device_constant((1.0, 1.0, 0.0), E.device)) @ v


def refit(x1, x2, w, low: bool = False):
    """The least-squares E of all correspondences weighted by the 0/1
    mask ``w``: the least right singular vector of the 9 epipolar
    columns, from the SVD of their float64 Gram, projected to the
    essential spectrum."""
    a = (epipolar_rows(x1, x2) * w[:, None].to(x1.dtype)).to(torch.float64)
    _, _, vt = svd(a.T @ a, low)
    return project_essential(vt[-1].reshape(3, 3).to(x1.dtype), low)


def triangulate_depths(R, t, x1, x2):
    """Two-view midpoint triangulation: the ray parameters (a, b) and the
    depths (z1, z2) of each point in both cameras, (..., N) each, for
    camera 2 at x_c2 = R x_c1 + t."""
    ones = torch.ones_like(x1[:, :1])
    f1 = torch.cat([x1, ones], dim=1)
    f1 = f1 / torch.linalg.vector_norm(f1, dim=1, keepdim=True)
    f2 = torch.cat([x2, ones], dim=1)
    f2 = f2 / torch.linalg.vector_norm(f2, dim=1, keepdim=True)
    r2 = f2 @ R
    d = -(R.transpose(-1, -2) @ t[..., None])[..., 0]    # o2 - o1
    r1r2 = (f1 * r2).sum(-1)
    r2d = (r2 * d[..., None, :]).sum(-1)
    a = ((f1 * d[..., None, :]).sum(-1) - r1r2 * r2d) / (
        1 - r1r2 ** 2).clamp_min(1e-12)
    b = r1r2 * a - r2d
    p1 = f1 * a[..., None]
    p2 = p1 @ R.transpose(-1, -2) + t[..., None, :]
    return a, b, p1[..., 2], p2[..., 2]


_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def recover_pose(E, x1, x2, mask, low: bool = False):
    """Of the four (R, t) of each E (..., 3, 3), the one with the most
    points in front of both cameras over ``mask``: (R, unit t, its
    support mask)."""
    u, _, vt = svd(E, low)
    u = u * torch.sign(det3(u))[..., None, None]
    vt = vt * torch.sign(det3(vt))[..., None, None]
    w = device_constant(_W, E.device)
    R1, R2 = u @ w @ vt, u @ w.T @ vt
    t = u[..., :, 2]
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)           # (..., 4, 3, 3)
    ts = torch.stack([t, -t, t, -t], dim=-2)             # (..., 4, 3)
    a, b, z1, z2 = triangulate_depths(Rs, ts, x1, x2)
    good = (a > 0) & (b > 0) & (z1 > 0) & (z2 > 0) & mask[..., None, :]
    best = good.to(torch.int32).sum(-1).argmax(-1)

    def pick(x):
        ix = best.reshape(best.shape + (1,) * (x.dim() - best.dim()))
        return torch.gather(x, best.dim(), ix.expand(
            best.shape + (1,) + x.shape[best.dim() + 1:])).squeeze(best.dim())

    return pick(Rs), pick(ts), pick(good)


def essential(x1, x2, mask, u, threshold: float, low: bool = False):
    """The frame's essential matrix from normalized points (N, 2) each,
    the matches ``mask`` (N,) and the uniforms ``u`` (iters, 5): (E,
    inlier mask, inliers)."""
    def msac_of(E):
        err = sampson_error(E, x1, x2, low).clamp_max(threshold)
        return held(torch.where(mask, err, 0.0).sum(-1), low)

    def support_of(E):
        inl = (sampson_error(E, x1, x2, low) < threshold) & mask
        _, _, good = recover_pose(E, x1, x2, inl, low)
        return good.to(torch.int32).sum(-1)

    idx = sample_indices(u, mask)
    Es, valid = candidates(x1[idx], x2[idx], low)        # (iters, 10, ...)
    msacs = torch.where(valid, msac_of(Es), float("inf"))
    flat_E = Es.reshape(-1, 3, 3)
    k = min(TOP_CANDIDATES, flat_E.shape[0])
    # ascending MSAC, ties to the lower index
    neg_top, top_i = torch.sort(-msacs.reshape(-1), descending=True,
                                stable=True)
    top_m, top_E = -neg_top[:k], flat_E[top_i[:k]]
    support = support_of(top_E)
    m_best = top_m[0]
    margin = torch.maximum(0.02 * m_best,
                           1e-3 * threshold * mask.to(torch.float32).sum())
    eligible = top_m <= m_best + margin
    best = int(torch.where(eligible, support, -1).argmax())
    E, cur_m, cur_sup = top_E[best], top_m[best], support[best]
    inliers = (sampson_error(E, x1, x2, low) < threshold) & mask
    for _ in range(REFIT_ROUNDS):
        E_ref = refit(x1, x2, inliers, low)
        m_ref = msac_of(E_ref)
        sup_ref = support_of(E_ref)
        if bool((m_ref <= 1.5 * cur_m)
                & (sup_ref.to(torch.float32) >= 0.7 * cur_sup.to(
                    torch.float32))
                & torch.isfinite(E_ref).all()):
            E, cur_m, cur_sup = E_ref, m_ref, sup_ref
        inliers = (sampson_error(E, x1, x2, low) < threshold) & mask
    return E, inliers, int(inliers.sum())
