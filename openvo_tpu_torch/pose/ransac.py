"""Fixed-iteration RANSAC, batched over hypotheses, PyTorch port of
``openvo_tpu/pose/ransac.py``:

- :func:`ransac_rigid`: robust 3D-3D rigid fit from minimal 3-point
  Kabsch hypotheses;
- :func:`ransac_essential` (8-point hypotheses) and
  :func:`ransac_essential_5pt` (Nister 5-point, the monocular path) with
  :func:`recover_pose`, the ``cv2.findEssentialMat`` + ``cv2.recoverPose``
  equivalents.

Where JAX takes a PRNG key, these take ``u``: the (iters, k) uniforms in
[0, 1) of the draw, or a ``torch.Generator`` to draw them from (None: a
generator on the points' device seeded 0). Indices follow
``jax.random.choice(key, n, (iters, k), p=mask / sum)`` exactly given the
same uniforms (:func:`sample_indices`), so a caller holding JAX's uniforms
replays JAX's samples. An empty mask draws index 0, as JAX does, with no
raise (``torch.multinomial`` would raise, or assert on the card).

Everything is static-shape with no host read: on the card every SVD is
the Jacobi kernel H11 (``pose/kabsch.svd``), so the mono step is captured
as one CUDA graph.
"""

from __future__ import annotations

import torch

from openvo_tpu_torch.ops._dispatch import device_constant
from openvo_tpu_torch.pose.fivepoint import (epipolar_rows,
                                             five_point_candidates)
from openvo_tpu_torch.pose.kabsch import (det3, jacobi_route, kabsch,
                                          row_norm, svd)

# base length of XLA:CPU's blocked cumulative sum (ReduceWindowRewriter)
_SCAN_BASE = 16


def _cumsum_blocked(p):
    """float32 inclusive cumulative sum of 1-D ``p`` in XLA:CPU's order: a
    sequential sum inside blocks of 16, each block offset by the
    (recursive) cumulative sum of the blocks before it."""
    n = p.shape[0]
    if n <= _SCAN_BASE:
        out = [p[0]]
        for i in range(1, n):
            out.append(out[-1] + p[i])
        return torch.stack(out)
    nb = -(-n // _SCAN_BASE)
    blocks = torch.nn.functional.pad(p, (0, nb * _SCAN_BASE - n)).view(
        nb, _SCAN_BASE)
    cols = [blocks[:, 0]]
    for i in range(1, _SCAN_BASE):
        cols.append(cols[-1] + blocks[:, i])
    inner = torch.stack(cols, dim=1)
    before = torch.cat([inner.new_zeros(1),
                        _cumsum_blocked(inner[:, -1])[:-1]])
    return (inner + before[:, None]).reshape(-1)[:n]


def uniforms(u, shape, device):
    """``u`` if it is a tensor of ``shape``, else draws from the generator
    ``u`` (None: a fresh one seeded 0) on ``device``."""
    if torch.is_tensor(u):
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"uniforms of shape {tuple(u.shape)}, expected "
                             f"{tuple(shape)}")
        return u.to(device=device, dtype=torch.float32)
    if u is None:
        u = torch.Generator(device=device).manual_seed(0)
    return torch.rand(shape, generator=u, device=device)


def sample_indices(u, mask):
    """(iters, k) int64 indices of valid rows, with replacement, from
    uniforms ``u`` (iters, k): ``jax.random.choice``'s
    ``searchsorted(cumsum(p), cumsum(p)[-1] * (1 - u))`` with p = mask /
    max(sum(mask), 1). Index 0 where no row is valid."""
    p = mask.to(torch.float32)
    p = p / p.sum().clamp_min(1.0)
    cum = _cumsum_blocked(p)
    r = cum[-1] * (1.0 - u)
    return torch.searchsorted(cum, r.reshape(-1).contiguous()).reshape(u.shape)


def _kabsch3(src, dst):
    """Rigid (B, 4, 4) transforms from B samples of 3 points (B, 3, 3),
    all rows valid (JAX's ``kabsch(..., ones(3))`` vmapped)."""
    mu_s = src.sum(1) / 3.0
    mu_d = dst.sum(1) / 3.0
    H = (src - mu_s[:, None]).transpose(1, 2) @ (dst - mu_d[:, None])
    U, _, Vt = svd(H)
    V = Vt.transpose(1, 2)
    Ut = U.transpose(1, 2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d),
                                      d], dim=-1))
    R = V @ D @ Ut
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    T = torch.eye(4, dtype=torch.float32, device=src.device).repeat(
        src.shape[0], 1, 1)
    T[:, :3, :3] = R
    T[:, :3, 3] = t
    return T


def _take(x, i):
    """``x[i]`` for a 0-d index tensor ``i``, by a gather: ``x[i]`` itself
    reads ``i`` back to the host."""
    return x.index_select(0, i.reshape(1))[0]


def _transform(T, pts):
    """Apply (..., 4, 4) transforms to (N, 3) points: (..., N, 3)."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def ransac_rigid(src, dst, mask, u=None, iters: int = 64,
                 inlier_threshold: float = 0.05):
    """Robust rigid fit of (N, 3) ``src`` to ``dst`` over ``mask``.
    Returns (T (4, 4), inlier mask (N,), n_inliers)."""
    idx = sample_indices(uniforms(u, (iters, 3), src.device), mask)
    Ts = _kabsch3(src[idx], dst[idx])
    err = row_norm(_transform(Ts, src) - dst)
    scores = ((err < inlier_threshold) & mask).to(torch.int32).sum(-1)
    scores = torch.where(torch.isnan(Ts).flatten(1).any(-1), -1, scores)
    T_best = _take(Ts, scores.argmax())
    err = row_norm(_transform(T_best, src) - dst)
    inliers = (err < inlier_threshold) & mask
    T_final = kabsch(src, dst, inliers)
    T_final = torch.where(torch.isnan(T_final).any(), T_best, T_final)
    return T_final, inliers, inliers.to(torch.int32).sum()


# ---------------------------------------------------------------------------
# Essential matrix (monocular path)
# ---------------------------------------------------------------------------

_SPECTRUM = (1.0, 1.0, 0.0)


def _project_essential(E):
    """The nearest matrix with the essential spectrum (1, 1, 0)."""
    u, _, v = svd(E)
    return (u * device_constant(_SPECTRUM, E.device)) @ v


def _eight_point(x1, x2):
    """Essential matrices from 8 normalized correspondences (..., 8, 2)."""
    _, _, vt = svd(epipolar_rows(x1, x2), full_matrices=True)
    E = vt[..., -1, :].reshape(vt.shape[:-2] + (3, 3))
    return _project_essential(E)


def sampson_error(E, x1, x2):
    """Squared Sampson distances (..., N) of normalized correspondences
    (N, 2) under essential matrices E (..., 3, 3)."""
    ones = torch.ones_like(x1[:, :1])
    h1 = torch.cat([x1, ones], dim=1)
    h2 = torch.cat([x2, ones], dim=1)
    Ex1 = h1 @ E.transpose(-1, -2)      # (..., N, 3)
    Etx2 = h2 @ E                       # (..., N, 3)
    num = (h2 * Ex1).sum(-1) ** 2
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2
           + Etx2[..., 1] ** 2)
    return num / den.clamp_min(1e-12)


def ransac_essential(x1, x2, mask, u=None, iters: int = 256,
                     inlier_threshold: float = 1e-3):
    """Robust essential matrix from normalized points (N, 2) each with
    8-point hypotheses. Returns (E, inlier mask, n_inliers)."""
    idx = sample_indices(uniforms(u, (iters, 8), x1.device), mask)
    Es = _eight_point(x1[idx], x2[idx])
    inl = (sampson_error(Es, x1, x2) < inlier_threshold) & mask
    E = _take(Es, inl.to(torch.int32).sum(-1).argmax())
    inliers = (sampson_error(E, x1, x2) < inlier_threshold) & mask
    return E, inliers, inliers.to(torch.int32).sum()


def _masked_eight_point(x1, x2, w):
    """Least-squares essential matrix from all correspondences weighted by
    the 0/1 mask ``w``, projected to the essential manifold (the inlier
    refit). For N >= 9 the thin SVD has the same V as JAX's full one,
    without its N x N U; on the card's route the SVD is H11's of the
    float64 Gram."""
    a = epipolar_rows(x1, x2) * w[:, None].to(x1.dtype)
    if jacobi_route(a):
        # H11 takes 9 rows at most: the float64 Gram A^T A has A's right
        # singular vectors, its least one last
        a = a.to(torch.float64)
        _, _, vt = svd(a.T @ a)
        return _project_essential(vt[-1].reshape(3, 3).to(x1.dtype))
    _, _, vt = svd(a, full_matrices=a.shape[0] < 9)
    return _project_essential(vt[-1].reshape(3, 3))


def ransac_essential_5pt(x1, x2, mask, u=None, iters: int = 64,
                         inlier_threshold: float = 1e-3,
                         top_candidates: int = 8, refit_rounds: int = 2):
    """Robust essential matrix with 5-point hypotheses (up to 10 E's a
    sample), JAX's selection: the ``top_candidates`` lowest truncated-
    Sampson sums (MSAC), the most cheirality support among those within a
    small margin of the best, then ``refit_rounds`` guarded least-squares
    refits over the inliers. Returns (E, inlier mask, n_inliers)."""
    idx = sample_indices(uniforms(u, (iters, 5), x1.device), mask)
    Es, valid = five_point_candidates(x1[idx], x2[idx])   # (iters, 10, ...)
    return select_essential(Es, valid, x1, x2, mask, inlier_threshold,
                            top_candidates, refit_rounds)


def select_essential(Es, valid, x1, x2, mask, inlier_threshold: float,
                     top_candidates: int = 8, refit_rounds: int = 2):
    """:func:`ransac_essential_5pt`'s choice among candidate E's (..., 3,
    3) with validity (...): the ``top_candidates`` lowest MSAC sums, the
    most cheirality support among those within the margin of the best,
    then the guarded refits. Returns (E, inlier mask, n_inliers)."""

    def msac_of(E):
        err = sampson_error(E, x1, x2)
        return torch.where(mask, err.clamp_max(inlier_threshold), 0.0).sum(-1)

    def support_of(E):
        inl = (sampson_error(E, x1, x2) < inlier_threshold) & mask
        _, _, good = recover_pose(E, x1, x2, inl)
        return good.to(torch.int32).sum(-1)

    msacs = torch.where(valid, msac_of(Es), float("inf"))
    flat_E = Es.reshape(-1, 3, 3)
    k = min(top_candidates, flat_E.shape[0])
    # lax.top_k(-msac): ascending MSAC, ties to the lower index
    neg_top, top_i = torch.sort(-msacs.reshape(-1), descending=True,
                                stable=True)
    top_m, top_E = -neg_top[:k], flat_E[top_i[:k]]
    support = support_of(top_E)
    m_best = top_m[0]
    margin = torch.maximum(0.02 * m_best,
                           1e-3 * inlier_threshold * mask.to(torch.float32)
                           .sum())
    eligible = top_m <= m_best + margin
    best = torch.where(eligible, support, -1).argmax()
    E, cur_m, cur_sup = (_take(x, best) for x in (top_E, top_m, support))
    inliers = (sampson_error(E, x1, x2) < inlier_threshold) & mask
    for _ in range(refit_rounds):
        E_ref = _masked_eight_point(x1, x2, inliers)
        m_ref = msac_of(E_ref)
        sup_ref = support_of(E_ref)
        ok = ((m_ref <= 1.5 * cur_m)
              & (sup_ref.to(torch.float32) >= 0.7 * cur_sup.to(torch.float32))
              & torch.isfinite(E_ref).all())
        E = torch.where(ok, E_ref, E)
        cur_m = torch.where(ok, m_ref, cur_m)
        cur_sup = torch.where(ok, sup_ref, cur_sup)
        inliers = (sampson_error(E, x1, x2) < inlier_threshold) & mask
    return E, inliers, inliers.to(torch.int32).sum()


def _triangulate_depths(R, t, x1, x2):
    """Two-view midpoint triangulation: the ray parameters (a, b) and the
    depths (z1, z2) of each point (N) in both cameras, (..., N) each, for
    camera 2 at x_c2 = R x_c1 + t (R (..., 3, 3), t (..., 3))."""
    ones = torch.ones_like(x1[:, :1])
    f1 = torch.cat([x1, ones], dim=1)
    f1 = f1 / torch.linalg.vector_norm(f1, dim=1, keepdim=True)
    f2 = torch.cat([x2, ones], dim=1)
    f2 = f2 / torch.linalg.vector_norm(f2, dim=1, keepdim=True)
    r2 = f2 @ R                                          # (..., N, 3)
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


def recover_pose(E, x1, x2, mask):
    """Decompose essential matrices E (..., 3, 3) and keep the (R, t) of
    the four with the most cheirality support over ``mask`` (..., N)
    (``cv2.recoverPose``). Returns (R, unit t, support mask)."""
    u, _, vt = svd(E)
    # proper rotations
    u = u * torch.sign(det3(u))[..., None, None]
    vt = vt * torch.sign(det3(vt))[..., None, None]
    w = device_constant(_W, E.device)
    R1, R2 = u @ w @ vt, u @ w.T @ vt
    t = u[..., :, 2]
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)           # (..., 4, 3, 3)
    ts = torch.stack([t, -t, t, -t], dim=-2)             # (..., 4, 3)
    a, b, z1, z2 = _triangulate_depths(Rs, ts, x1, x2)   # (..., 4, N)
    good = (a > 0) & (b > 0) & (z1 > 0) & (z2 > 0) & mask[..., None, :]
    best = good.to(torch.int32).sum(-1).argmax(-1)       # (...)

    def pick(x):
        ix = best.reshape(best.shape + (1,) * (x.dim() - best.dim()))
        return torch.gather(x, best.dim(), ix.expand(
            best.shape + (1,) + x.shape[best.dim() + 1:])).squeeze(best.dim())

    return pick(Rs), pick(ts), pick(good)
