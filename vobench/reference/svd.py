"""The small SVDs of the plain reference's monocular path: one-sided
(Hestenes) Jacobi in float64, the column pairs in round-robin order, and a
wide matrix first reduced by LAPACK's float32 LQ (sgelq2/sorgl2 with
OpenBLAS's arithmetic), which gives the null-space basis of JAX's SVD on
the CPU bit for bit.

Frozen copy of the plain versions in ``openvo_tpu_torch/pose/kabsch.py``
(``svd`` on the card's route, ``jacobi_svd_plain``, ``_lapack_lq``,
``jacobi_rounds``) of the commit that added the monocular cell: plain
PyTorch, no kernel, no import of the program, so that a later change to
the program cannot move it.

``low=True`` is the control: the Jacobi sweeps in float32, the next
precision below float64 (the LQ stays float32).
"""

from __future__ import annotations

import torch

from vobench.reference.geometry import _chain_sum, _left_3x3, _rotate
from vobench.reference.image import fma

# a pair (p, q) is not rotated where |g_pq| <= TOL * sqrt(g_pp g_qq); a
# matrix is done after a sweep that rotated nothing, else after MAX_SWEEPS
JACOBI_TOL = 1e-14
JACOBI_MAX_SWEEPS = 12


def det3(m):
    """Determinants of (..., 3, 3) as the triple product of the rows."""
    return (torch.linalg.cross(m[..., 0, :], m[..., 1, :])
            * m[..., 2, :]).sum(-1)


def jacobi_rounds(n):
    """The order of the column pairs (p, q), p < q, of a sweep over n
    columns: the round-robin (circle) schedule of n' = n rounded up to even
    columns, n' - 1 rounds of n'/2 disjoint pairs, the pairs holding the
    pad column n dropped. Round r pairs x = n' - 2 - r with n' - 1 and x +
    k with x - k (mod n' - 1)."""
    n2 = n + (n & 1)
    m1 = n2 - 1
    rounds = []
    for r in range(m1):
        x = m1 - 1 - r
        pairs = [(x, n2 - 1)] + [((x + k) % m1, (x - k) % m1)
                                 for k in range(1, n2 // 2)]
        rounds.append(sorted((min(p), max(p)) for p in pairs
                             if max(p) < n))
    return rounds


def _slapy2(x, y):
    """LAPACK's slapy2 in float32: w sqrt(1 + (z/w)^2), w = max(|x|, |y|),
    z = min(|x|, |y|); w where z is 0; the root taken in float64 and
    rounded (the correctly rounded float32 root)."""
    w, z = torch.maximum(x.abs(), y.abs()), torch.minimum(x.abs(), y.abs())
    q = z / torch.where(z == 0, 1.0, w)
    root = torch.sqrt((1.0 + q * q).to(torch.float64)).to(torch.float32)
    return torch.where(z == 0, w, w * root)


def _slarf_right(C, v, tau):
    """LAPACK's slarf('Right') as OpenBLAS computes it: C (B, r, L) <- C (I
    - tau v v^T), w = C v a chain of fused multiply-adds (sgemv), then C +=
    (-tau v_j) w_r by fused multiply-adds (sger); C as it is where tau is
    0."""
    w = fma(C[..., 0], v[:, None, 0], torch.zeros_like(C[..., 0]))
    for j in range(1, v.shape[-1]):
        w = fma(C[..., j], v[:, None, j], w)
    t = -tau[:, None] * v
    out = fma(t[:, None, :], w[..., None], C)
    return torch.where((tau == 0)[:, None, None], C, out)


def lapack_lq(a):
    """(L (B, m, m), Q (B, n, n)) of ``a = L Q[:m]`` for float32 (B, m, n),
    m < n: sgelq2's reflectors (slarfg: beta = -copysign(slapy2(alpha,
    |x|), alpha), tau = (beta - alpha) / beta, v = (1, x / (alpha -
    beta)); H(i) = I where x is 0), then sorgl2's Q = H(m-1) ... H(0).
    Q[m:] is the basis of a's null space."""
    B, m, n = a.shape
    rows = list(a.unbind(1))
    taus = []
    for i in range(m):
        alpha, x = rows[i][:, i], rows[i][:, i + 1:]
        xd = x.to(torch.float64)
        xnorm = torch.sqrt(_chain_sum(xd * xd)).to(torch.float32)
        zero = xnorm == 0
        beta = -torch.copysign(_slapy2(alpha, xnorm), alpha)
        tau = torch.where(zero, 0.0, (beta - alpha) / beta)
        scale = 1.0 / (alpha - beta)
        tail = torch.where(zero[:, None], x, x * scale[:, None])
        rows[i] = torch.cat([rows[i][:, :i],
                             torch.where(zero, alpha, beta)[:, None], tail],
                            dim=1)
        if i + 1 < m:
            v = torch.cat([torch.ones_like(alpha)[:, None], tail], dim=1)
            C = _slarf_right(torch.stack(rows[i + 1:], dim=1)[:, :, i:], v,
                             tau)
            rows[i + 1:] = [torch.cat([r[:, :i], c], dim=1)
                            for r, c in zip(rows[i + 1:], C.unbind(1))]
        taus.append(tau)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    Q = rows + [eye[r].expand(B, n) for r in range(m, n)]
    for i in reversed(range(m)):
        tail, tau = Q[i][:, i + 1:], taus[i]
        v = torch.cat([torch.ones_like(tau)[:, None], tail], dim=1)
        C = _slarf_right(torch.stack(Q[i + 1:], dim=1)[:, :, i:], v, tau)
        Q[i + 1:] = [torch.cat([q[:, :i], c], dim=1)
                     for q, c in zip(Q[i + 1:], C.unbind(1))]
        Q[i] = torch.cat([torch.zeros_like(Q[i][:, :i]),
                          (1.0 - tau)[:, None], tail * (-tau)[:, None]],
                         dim=1)
    return (torch.tril(torch.stack(rows, dim=1)[:, :, :m]),
            torch.stack(Q, dim=1))


def hestenes(a):
    """One-sided Jacobi on (B, m, n) ``a`` in its own type: (S (B, n)
    descending, ties to the lower index; V (B, n, n) in S's order; U (B,
    3, 3) where m = n = 3, else None). Each round of :func:`jacobi_rounds`
    rotates its disjoint pairs at once; a matrix done is left as it is."""
    B, m, n = a.shape
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(B, n, n)
    cols = list(torch.cat([a, eye], dim=-2).unbind(-1))   # A over V
    rounds = [r for r in jacobi_rounds(n) if r]
    for _ in range(JACOBI_MAX_SWEEPS):
        for pairs in rounds:
            x = torch.stack([cols[p] for p, _ in pairs], dim=1)   # (B, k, L)
            y = torch.stack([cols[q] for _, q in pairs], dim=1)
            xa, ya = x[..., :m], y[..., :m]
            g_pp, g_qq, g_pq = _chain_sum(torch.stack(
                [xa * xa, ya * ya, xa * ya], dim=2)).unbind(-1)
            rot = ~(g_pq.abs() <= JACOBI_TOL * torch.sqrt(g_pp * g_qq))
            x2, y2 = _rotate(x, y, g_pp, g_qq, g_pq)
            x2 = torch.where(rot[..., None], x2, x).unbind(1)
            y2 = torch.where(rot[..., None], y2, y).unbind(1)
            for (p, q), xp, yq in zip(pairs, x2, y2):
                cols[p], cols[q] = xp, yq
    M = torch.stack(cols, dim=-1)
    A, V = M[:, :m, :], M[:, m:, :]
    norm = torch.sqrt(_chain_sum((A * A).transpose(-1, -2)))
    S, order = torch.sort(norm, dim=-1, descending=True, stable=True)
    A = A.gather(-1, order[:, None, :].expand(B, m, n))
    V = V.gather(-1, order[:, None, :].expand(B, n, n))
    U = _left_3x3(A, V, S).transpose(-1, -2) if m == n == 3 else None
    return S, V, U


def jacobi_svd(a, low: bool = False):
    """(S (B, n), V (B, n, n), U or None) of (B, m, n) ``a``, m, n <= 9:
    float64 ``a`` (m >= n) swept itself; float32 ``a`` (m < n) through its
    LQ, the sweeps on L in float64, V's first m columns Q[:m]^T V_L and
    its last n - m the rows Q[m:]. ``low``: the sweeps in float32."""
    B, m, n = a.shape
    work = torch.float32 if low else torch.float64
    if m >= n:
        S, V, U = hestenes(a.to(work))
        return S, V, U
    L, Q = lapack_lq(a)
    S, VL, _ = hestenes(L.to(work))
    Q = Q.to(work)
    top = _chain_sum((Q[:, :m, :, None] * VL[:, :, None, :]).movedim(1, -1))
    V = torch.cat([top, Q[:, m:, :].transpose(-1, -2)], dim=-1)
    return torch.cat([S, S.new_zeros((B, n - m))], dim=-1), V, None


def svd(a, low: bool = False):
    """(U, S, Vh) of (..., m, n), m, n <= 9, as the program's SVD on the
    card: a matrix holding a non-finite value gives NaN (the SVD runs on
    zeros in its place); float32 where m < n, else float64; cast back to
    ``a``'s type; Vh n x n, S min(m, n) values descending, U for 3x3
    only (else None)."""
    finite = torch.isfinite(a).all(dim=-1).all(dim=-1)
    clean = torch.where(finite[..., None, None], a, 0.0)
    lead, (m, n) = a.shape[:-2], a.shape[-2:]
    x = clean.reshape((-1, m, n)).to(torch.float32 if m < n
                                     else torch.float64)
    S, V, U = jacobi_svd(x, low)
    k = min(m, n)
    nan = float("nan")
    U = (None if U is None else
         torch.where(finite[..., None, None],
                     U.to(a.dtype).reshape(lead + (3, 3)), nan))
    S = torch.where(finite[..., None], S[:, :k].to(a.dtype).reshape(
        lead + (k,)), nan)
    Vh = torch.where(finite[..., None, None], V.transpose(-1, -2).to(
        a.dtype).reshape(lead + (n, n)), nan)
    return U, S, Vh
