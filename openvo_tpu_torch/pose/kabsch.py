"""Masked rigid 3D-3D alignment (Kabsch, rotation forced), the outlier
pass's residual and the small SVDs of the pose fits, PyTorch port of
``openvo_tpu/pose/kabsch.py``.

R from the SVD of the masked cross-covariance with the determinant-sign
fix, t = mean(dst) - R mean(src). With fewer than 3 valid points the result
is all NaN on purpose, and so is the fit of a NaN or inf valid row: the
odometer's NaN gate catches it. The whole fit is the operator
``openvo_torch::kabsch_fit``: the kernel H10 on the card (a block a fit:
the masked sums as fixed pairwise trees, then a fixed count of Jacobi
sweeps), its plain version :func:`kabsch_fit_plain` on the CPU. It never
reads the host, so the odometer's step can be captured as one CUDA
graph.

:func:`svd` serves RANSAC and the five-point solver. On the card it is the
batched one-sided Jacobi SVD H11 (the operator ``openvo_torch::jacobi_svd``,
plain version :func:`jacobi_svd_plain`), which reads nothing back, so the
mono step is captured too; on the CPU it stays ``torch.linalg.svd``
(LAPACK, as ``jnp.linalg.svd`` on JAX's CPU), unless
:func:`card_svd_route` asks for the card's route there.
"""

from __future__ import annotations

import contextlib

import torch

from openvo_tpu_torch.geometry.se3 import rt_to_T
from openvo_tpu_torch.ops import jacobi_cuda
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


JACOBI_SWEEPS = 5   # H10: cyclic sweeps of the rotations (0, 1), (0, 2), (1, 2)
# H11: a sweep rotates the column pairs in the round-robin order of
# jacobi_rounds; the rotation of columns p, q is skipped where |g_pq| <=
# JACOBI_TOL * sqrt(g_pp g_qq) (g = A^T A over the columns, the Gram); a
# matrix whose sweep made no rotation is done (a later sweep would skip
# every rotation again), the others stop after JACOBI_MAX_SWEEPS. On the
# bench corridor's frame 1 the refit's 9x9 Gram converges by sweep 7 and the
# five-point rows' 5x5 L by sweep 4-5 (chip_smoke.py's phase 2). A column of rounding noise never
# passes the test; a wide matrix's null columns would be such columns, but
# it is reduced to its square L first (LAPACK's path, jacobi_svd_plain).
# The wide path's float32 LQ is LAPACK's: with a Jacobi basis of the null
# space the bench corridor's mono run parts from JAX's a hundred times
# further (PERF.md section 6).
JACOBI_TOL = 1e-14
JACOBI_MAX_SWEEPS = 12

_card_route = 0


@contextlib.contextmanager
def card_svd_route():
    """Inside the block :func:`svd` takes the card's route on CPU tensors
    too: H11's operator, whose CPU kernel is the plain version (tests)."""
    global _card_route
    _card_route += 1
    try:
        yield
    finally:
        _card_route -= 1


def jacobi_route(a) -> bool:
    """Whether :func:`svd` of ``a`` runs H11's operator: on the card, and
    inside :func:`card_svd_route`."""
    return a.device.type == "cuda" or _card_route > 0


def svd(a, full_matrices=True):
    """The SVD (U, S, Vh) of (..., m, n) that, like LAPACK under JAX,
    returns NaN for a matrix holding a non-finite value instead of raising:
    the SVD runs on a finite stand-in and NaN goes where LAPACK puts it.

    On the CPU ``torch.linalg.svd``. On the card (:func:`jacobi_route`)
    H11 (float64 Jacobi; a wide matrix's LQ in float32, as LAPACK's under
    JAX), cast back to ``a``'s type, for m, n <= 9: Vh is n x n
    whatever ``full_matrices`` says, S holds min(m, n) values in
    descending order, and U is None unless m = n = 3 (no caller reads the
    left vectors of another shape)."""
    finite = torch.isfinite(a).all(dim=-1).all(dim=-1)
    clean = torch.where(finite[..., None, None], a, 0.0)
    if jacobi_route(a):
        U, S, Vh = _svd_jacobi(clean)
    else:
        U, S, Vh = torch.linalg.svd(clean, full_matrices=full_matrices)
    nan = float("nan")
    return (None if U is None else torch.where(finite[..., None, None], U,
                                               nan),
            torch.where(finite[..., None], S, nan),
            torch.where(finite[..., None, None], Vh, nan))


def jacobi_input(a):
    """(..., m, n) ``a`` as H11's operator takes it: (B, m, n), float32
    where m < n (LAPACK's float32 path), else float64."""
    m, n = a.shape[-2:]
    return a.reshape((-1, m, n)).to(torch.float32 if m < n
                                    else torch.float64)


def _svd_jacobi(a):
    lead, (m, n) = a.shape[:-2], a.shape[-2:]
    S, V, U, _ = torch.ops.openvo_torch.jacobi_svd(jacobi_input(a))
    k = min(m, n)
    return (U.to(a.dtype).reshape(lead + (3, 3)) if m == n == 3 else None,
            S[:, :k].to(a.dtype).reshape(lead + (k,)),
            V.transpose(-1, -2).to(a.dtype).reshape(lead + (n, n)))


def det3(m):
    """Determinants of (..., 3, 3) as the triple product of the rows: no
    LU factorisation, no host read."""
    return (torch.linalg.cross(m[..., 0, :], m[..., 1, :])
            * m[..., 2, :]).sum(-1)


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


def jacobi_rounds(n):
    """H11's order of the column pairs (p, q), p < q, of a sweep over n
    columns: the round-robin (circle) schedule of n' = n rounded up to even
    columns, n' - 1 rounds of n'/2 disjoint pairs, the pairs holding the
    pad column n dropped. Round r pairs x = n' - 2 - r with n' - 1 and x +
    k with x - k (mod n' - 1); for n = 3 that is the cyclic (0, 1), (0, 2),
    (1, 2). A list of rounds, each a list of pairs."""
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


def _slapy2(x, y):
    """LAPACK's slapy2 in float32: sqrt(x^2 + y^2) as w sqrt(1 + (z/w)^2),
    w = max(|x|, |y|), z = min(|x|, |y|); w where z is 0. The square root
    is taken in float64 and rounded, which is the correctly rounded float32
    root (torch's float32 sqrt on the CPU is not always)."""
    w, z = torch.maximum(x.abs(), y.abs()), torch.minimum(x.abs(), y.abs())
    q = z / torch.where(z == 0, 1.0, w)
    root = torch.sqrt((1.0 + q * q).to(torch.float64)).to(torch.float32)
    return torch.where(z == 0, w, w * root)


def _slarf_right(C, v, tau):
    """LAPACK's slarf('Right') as OpenBLAS computes it: C (B, r, L) <- C (I
    - tau v v^T), w = C v a chain of fused multiply-adds over v's entries
    (sgemv), then C += (-tau v_j) w_r by fused multiply-adds (sger); C as
    it is where tau is 0. float32, the fused multiply-adds as
    ``ops/image.fma``'s."""
    w = fma(C[..., 0], v[:, None, 0], torch.zeros_like(C[..., 0]))
    for j in range(1, v.shape[-1]):
        w = fma(C[..., j], v[:, None, j], w)
    t = -tau[:, None] * v
    out = fma(t[:, None, :], w[..., None], C)
    return torch.where((tau == 0)[:, None, None], C, out)


def _lapack_lq(a):
    """(L, Q) of the LQ factorisation ``a = L Q[:m]`` of float32 (B, m, n),
    m < n, as JAX's SVD computes it on the CPU: LAPACK's sgelq2 and sorgl2
    (the unblocked routines sgelqf and sorglq run at these sizes) with
    OpenBLAS's arithmetic: snrm2 in float64, sgemv a chain of fused
    multiply-adds, sger fused multiply-adds of (-tau v_j) w_r. Reflector
    H(i) = I - tau v v^T zeroes row i right of the diagonal (slarfg: beta
    = -copysign(slapy2(alpha, |x|), alpha), tau = (beta - alpha) / beta, v
    = (1, x / (alpha - beta)) scaled by the reciprocal; H(i) = I where x
    is 0). L (B, m, m) lower triangular and Q (B, n, n) = H(m-1) ... H(0),
    both float32; Q[m:] is LAPACK's basis of a's null space, bit for bit
    (``tests/test_torch_jacobi.py``)."""
    B, m, n = a.shape
    rows = list(a.unbind(1))                           # (B, n) each
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


def _hestenes(a):
    """:func:`jacobi_svd_plain`'s one-sided Jacobi on (B, m, n) ``a``
    directly: (S (B, n), V (B, n, n), U (B, 3, 3) or (B, 0, 0), sweeps).
    Each round of :func:`jacobi_rounds` rotates its disjoint pairs as one
    batched step, as H11's lanes rotate them at once."""
    B, m, n = a.shape
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(B, n, n)
    cols = list(torch.cat([a, eye], dim=-2).unbind(-1))   # A over V
    done = torch.zeros(B, dtype=torch.bool, device=a.device)
    sweeps = torch.zeros(B, dtype=torch.int32, device=a.device)
    rounds = [r for r in jacobi_rounds(n) if r]
    for _ in range(JACOBI_MAX_SWEEPS):
        rotated = torch.zeros_like(done)
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
            rotated = rotated | rot.any(-1)
        sweeps = sweeps + (~done).to(torch.int32)
        done = done | ~rotated
    M = torch.stack(cols, dim=-1)
    A, V = M[:, :m, :], M[:, m:, :]
    norm = torch.sqrt(_chain_sum((A * A).transpose(-1, -2)))
    S, order = torch.sort(norm, dim=-1, descending=True, stable=True)
    A = A.gather(-1, order[:, None, :].expand(B, m, n))
    V = V.gather(-1, order[:, None, :].expand(B, n, n))
    U = (_left_3x3(A, V, S).transpose(-1, -2) if m == n == 3
         else a.new_empty((B, 0, 0)))
    return S, V, U, sweeps


def jacobi_svd_plain(a):
    """H11's plain version: the SVD of B matrices ``a`` (B, m, n), m, n <=
    9 (``ops/jacobi_cuda.MAX_DIM``), by one-sided (Hestenes) Jacobi in
    float64. Returns

    - S (B, n): the singular values in descending order (ties to the lower
      index), then n - m zeros where m < n;
    - V (B, n, n): the right singular vectors, in S's order;
    - U (B, 3, 3) where m = n = 3 (columns u_1 = a v_1 / s_1, u_2, and u_3
      = u_1 x u_2, as :func:`rotation_3x3_plain` makes them), else (B, 0,
      0);
    - sweeps (B,) int32: the Jacobi sweeps H11 runs on each matrix.

    Where m >= n (float64 ``a``) the sweeps rotate the columns of ``a``
    itself. Where m < n (float32 ``a``, the five-point solver's rows) it
    takes JAX's path on the CPU, LAPACK's sgesdd for n >= 11m/6: the LQ
    factorisation ``a = L Q[:m]`` as :func:`_lapack_lq` computes it, the
    sweeps on the m x m L, V's first m columns Q[:m]^T V_L, its last n - m
    the rows Q[m:]: JAX's basis of the null space, bit for bit, which the
    float32 five-point solver's candidates depend on.

    A sweep rotates the column pairs (p, q), p < q, in the round-robin
    order of :func:`jacobi_rounds` (each round's pairs are disjoint, so
    they rotate at once), skipping a pair by JACOBI_TOL's test; it runs
    JACOBI_MAX_SWEEPS sweeps over the batch (a matrix done is left as it
    is, bit for bit), with every sum a left-to-right chain and every
    operation correctly rounded, so the kernel, which stops each matrix
    when it is done, gives the same bits."""
    B, m, n = a.shape
    want = torch.float32 if m < n else torch.float64
    if a.dtype != want:
        raise TypeError(f"jacobi_svd: {m}x{n} matrices of {a.dtype}, "
                        f"expected {want}")
    if m >= n:
        return _hestenes(a)
    L, Q = _lapack_lq(a)
    S, VL, _, sweeps = _hestenes(L.to(torch.float64))
    Q = Q.to(torch.float64)
    top = _chain_sum((Q[:, :m, :, None] * VL[:, :, None, :]).movedim(1, -1))
    V = torch.cat([top, Q[:, m:, :].transpose(-1, -2)], dim=-1)
    return (torch.cat([S, S.new_zeros((B, n - m))], dim=-1), V,
            S.new_empty((B, 0, 0)), sweeps)


@torch.library.custom_op("openvo_torch::jacobi_svd", mutates_args=(),
                         device_types="cpu")
def _jacobi_svd_op(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor, torch.Tensor]:
    return jacobi_svd_plain(a)


@_jacobi_svd_op.register_kernel("cuda")
def _(a):
    return jacobi_cuda.jacobi_svd(a.contiguous(), JACOBI_TOL,
                                  JACOBI_MAX_SWEEPS)


@_jacobi_svd_op.register_fake
def _(a):
    B, m, n = a.shape
    return (a.new_empty((B, n)), a.new_empty((B, n, n)),
            a.new_empty((B, 3, 3) if m == n == 3 else (B, 0, 0)),
            a.new_empty((B,), dtype=torch.int32))


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


@torch.library.custom_op("openvo_torch::kabsch_fit", mutates_args=(),
                         device_types="cpu")
def _kabsch_fit_op(src: torch.Tensor, dst: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    return kabsch_fit_plain(src, dst, mask)


@_kabsch_fit_op.register_kernel("cuda")
def _(src, dst, mask):
    return jacobi_cuda.kabsch_fit(src.contiguous(), dst.contiguous(),
                                  mask.contiguous())


@_kabsch_fit_op.register_fake
def _(src, dst, mask):
    return src.new_empty((src.shape[0], 4, 4))


def kabsch(src, dst, mask):
    """Best-fit rigid (4, 4) float32 transform mapping ``src`` (N, 3) ->
    ``dst`` over the rows where ``mask`` holds. Invalid rows may hold
    anything (inf, NaN): they are zeroed before the reduction; NaNs in
    valid rows poison the fit on purpose. A batch, (..., N, 3) with a
    (..., N) mask, gives (..., 4, 4).

    The points are taken in float32, as the JAX package fits them. The fit
    runs in float64 and rounds once to float32 at the end: the products of
    float32 values are exact and the sums round near 1e-16. Every sum is a
    fixed pairwise tree over the points, so a batched call gives each
    member its own call's bits. The fit is the operator
    ``openvo_torch::kabsch_fit`` (H10 on the card, :func:`kabsch_fit_plain`
    on the CPU), which makes no host sync (the fit runs inside a captured
    CUDA graph); a non-finite H gives NaN, as LAPACK under JAX."""
    lead, n = mask.shape[:-1], mask.shape[-1]
    T = torch.ops.openvo_torch.kabsch_fit(
        src.to(torch.float32).reshape((-1, n, 3)),
        dst.to(torch.float32).reshape((-1, n, 3)), mask.reshape((-1, n)))
    return T.reshape(lead + (4, 4))


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
