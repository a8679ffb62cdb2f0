"""Nister's 5-point minimal essential-matrix solver, PyTorch port of
``openvo_tpu/pose/fivepoint.py``, batched over hypotheses by a leading
dimension:

1. null space: the SVD of the 5x9 epipolar system gives 4 basis matrices
   X, Y, Z, W with E = x X + y Y + z Z + W;
2. the 10 cubic constraints (det E = 0 and 2 E E^T E - tr(E E^T) E = 0)
   as a (10, 20) coefficient matrix over Nister's monomial order. The JAX
   package expands them symbolically at trace time into thousands of
   scalar ops, which XLA fuses; here the same cubic forms are a constant
   (10, 9, 9, 9) tensor contracted with the basis three times, a few
   batched products instead of thousands of launches;
3. Gauss-Jordan (one 10x10 solve) and Nister's row combinations reduce
   the system to B(z) [x, y, 1]^T = 0, hence n(z) = det B(z), degree 10;
4. real roots by a sign-change scan over theta = atan(z) (512 cells) and
   48 bisection steps: fixed shapes, no host sync;
5. back-substitution per root by null-vector cross products: up to 10
   candidate E's per sample, invalid slots masked.

From the reduction to B(z) in step 3 to the end of step 5, the solver is
:func:`five_point_roots`: on the card the kernel H12 (``csrc/fivepoint.cu``,
``ops/fivepoint_cuda.py``), one launch for what ATen runs as ~800 small
kernels; on the CPU its plain version :func:`five_point_roots_plain`. H12
adds and multiplies in the order ATen's and cuBLAS's kernels take on the
card (the kernel's header says which), so it gives the plain version's
bits there, and the benchmark's frozen reference's.

A singular 10x10 system gives NaN or garbage candidates, which lose the
RANSAC vote, as in JAX: ``torch.linalg.solve_ex`` neither raises nor syncs.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from openvo_tpu_torch.ops import fivepoint_cuda
from openvo_tpu_torch.ops._dispatch import device_constant
from openvo_tpu_torch.pose.kabsch import svd

# Nister's 20-monomial order (x, y, z exponents): the first 10 columns are
# eliminated by Gauss-Jordan; the last 10 are the x/y/1-times-z-power groups.
_MONOMIALS = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_MONO_INDEX = {m: i for i, m in enumerate(_MONOMIALS)}
# E = x X + y Y + z Z + 1 W: the exponent each basis slot adds
_SLOT_EXP = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]

_N_GRID = 512
_N_BISECT = 48
_MAX_ROOTS = 10


def _cubic_forms():
    """(10, 9, 9, 9) float32: constraint j = sum C[j, a, b, c] E_a E_b E_c
    over the row-major entries of E (det E first, then G = 2 E E^T E -
    tr(E E^T) E row by row)."""
    C = np.zeros((10, 9, 9, 9), np.float64)
    for perm in itertools.permutations(range(3)):
        sign = np.linalg.det(np.eye(3)[list(perm)])
        C[0, perm[0], 3 + perm[1], 6 + perm[2]] += sign
    for r, c in itertools.product(range(3), range(3)):
        j = 1 + 3 * r + c
        for k, l in itertools.product(range(3), range(3)):
            C[j, 3 * r + k, 3 * l + k, 3 * l + c] += 2.0
        for a in range(9):
            C[j, a, a, 3 * r + c] -= 1.0
    return C.astype(np.float32)


def _monomial_map():
    """(64, 20) float32: the monomial of each ordered triple of basis
    slots."""
    S = np.zeros((64, 20), np.float32)
    for i, (m1, m2, m3) in enumerate(itertools.product(range(4), repeat=3)):
        e = tuple(map(sum, zip(_SLOT_EXP[m1], _SLOT_EXP[m2], _SLOT_EXP[m3])))
        S[i, _MONO_INDEX[e]] = 1.0
    return S


def _constraint_rows(basis):
    """The 10 cubic constraints as (..., 10, 20) coefficients over
    ``_MONOMIALS``; ``basis`` is (..., 4, 3, 3): X, Y, Z, W."""
    C = device_constant(_cubic_forms, basis.device)
    S = device_constant(_monomial_map, basis.device)
    b = basis.reshape(basis.shape[:-2] + (9,))          # (..., 4 slots, 9)
    t = torch.einsum("jabc,...nc->...jabn", C, b)
    t = torch.einsum("...jabn,...mb->...jamn", t, b)
    t = torch.einsum("...jamn,...la->...jlmn", t, b)    # (..., 10, 4, 4, 4)
    return t.reshape(t.shape[:-3] + (64,)) @ S


def _z_index():
    """(2, 45) gather indices of :func:`_z_matrix` into M's 100 entries
    plus a zero at 100: B[r, c, p] = M[IA] - M[IB]."""
    zero = 100
    ia = np.full((3, 3, 5), zero, np.int64)
    ib = np.full((3, 3, 5), zero, np.int64)
    # per column group: [z^0 .. z^4] = a[k0], a[k1] - b[k0], ... (JAX's pair)
    groups = [(2, 1, 0, None), (5, 4, 3, None), (9, 8, 7, 6)]
    for r, (pe, pf) in enumerate([(4, 5), (6, 7), (8, 9)]):
        for c, g in enumerate(groups):
            ks = [k for k in g if k is not None]
            for p in range(len(ks) + 1):
                if p < len(ks):
                    ia[r, c, p] = 10 * pe + ks[p]
                if p > 0:
                    ib[r, c, p] = 10 * pf + ks[p - 1]
    return np.stack([ia.reshape(-1), ib.reshape(-1)])


def _z_matrix(M):
    """Nister's reduction of the eliminated system (..., 10, 10) to the
    (..., 3, 3, 5) z-polynomial matrix B(z) ([row][col][z-power]): rows
    <e> - z<f>, <g> - z<h>, <i> - z<j> of the reduced system."""
    ia, ib = device_constant(_z_index, M.device, torch.int64)
    flat = torch.cat([M.reshape(M.shape[:-2] + (100,)),
                      M.new_zeros(M.shape[:-2] + (1,))], dim=-1)
    return (flat[..., ia] - flat[..., ib]).reshape(M.shape[:-2] + (3, 3, 5))


def _conv(a, v):
    """Full convolution of coefficient vectors (..., n) and (..., m), as
    jnp.convolve lays it out: the longer one padded, the taps of the
    other reversed, summed tap by tap."""
    if v.shape[-1] > a.shape[-1]:
        a, v = v, a
    n, m = a.shape[-1], v.shape[-1]
    pad = torch.nn.functional.pad(a, (m - 1, m - 1))
    out = pad[..., :n + m - 1] * v[..., m - 1:]
    for k in range(1, m):
        out = out + pad[..., k:k + n + m - 1] * v[..., m - 1 - k:m - k]
    return out


def _det_poly(B):
    """det of the (..., 3, 3, 5) z-polynomial matrix: (..., 13)
    coefficients (true degree 10; the top ones vanish analytically)."""
    # the three minors of rows 1, 2 against columns (1, 2), (0, 2), (0, 1)
    c0 = device_constant((1, 0, 0), B.device, torch.int64)
    c1 = device_constant((2, 2, 1), B.device, torch.int64)
    r1, r2 = B[..., 1, :, :], B[..., 2, :, :]
    minors = (_conv(r1.index_select(-2, c0), r2.index_select(-2, c1))
              - _conv(r1.index_select(-2, c1), r2.index_select(-2, c0)))
    t = _conv(B[..., 0, :, :], minors)                      # (..., 3, 13)
    return t[..., 0, :] - t[..., 1, :] + t[..., 2, :]


def _theta_grid():
    """The scan's theta grid, float32, as jnp.linspace computes it."""
    eps = 1e-4
    lo, hi = np.float32(-np.pi / 2 + eps), np.float32(np.pi / 2 - eps)
    h = np.arange(_N_GRID - 1, dtype=np.float32) / np.float32(_N_GRID - 1)
    g = lo * (np.float32(1) - h) + hi * h
    return np.append(g, hi).astype(np.float32)


def _q(c, theta):
    """q(theta) = sum_i c_i sin^i cos^(12-i) of coefficients c (..., 13) at
    theta (..., m): (..., m)."""
    deg = c.shape[-1] - 1
    exps = device_constant(tuple(range(deg + 1)), c.device)
    s, co = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    return (c[..., None, :] * torch.pow(s, exps)
            * torch.pow(co, deg - exps)).sum(-1)


def _scan(n_coeffs):
    """The sign-change scan of :func:`_real_roots`: the coefficients over
    their largest |c_i| + 1e-30 (..., 13), q at the theta grid (..., 512)
    and the cells whose ends differ in sign (..., 511)."""
    scale = n_coeffs.abs().amax(dim=-1, keepdim=True) + 1e-30
    c = n_coeffs / scale
    grid = device_constant(_theta_grid, c.device)
    qs = _q(c, grid.expand(c.shape[:-1] + (_N_GRID,)))
    return c, qs, qs[..., :-1] * qs[..., 1:] < 0


def _real_roots(n_coeffs):
    """Up to 10 real roots of the degree-<=12 polynomials (..., 13), over
    the whole real line by z = tan(theta): q(theta) = sum_i c_i sin^i
    cos^(12-i) is bounded and has the sign pattern of n(z). Returns roots
    (..., 10) and valid (..., 10)."""
    c, qs, sc = _scan(n_coeffs)
    grid = device_constant(_theta_grid, c.device)
    # lax.top_k of (sc - cell * 1e-9) takes the sign-change cells in
    # ascending order, then the other cells: a stable sort on ~sc
    idx = torch.sort((~sc).to(torch.uint8), dim=-1,
                     stable=True).indices[..., :_MAX_ROOTS]
    valid = torch.gather(sc, -1, idx)
    lo = grid[idx]
    hi = grid[(idx + 1).clamp_max(_N_GRID - 1)]
    qlo = _q(c, lo)
    for _ in range(_N_BISECT):
        mid = 0.5 * (lo + hi)
        qm = _q(c, mid)
        same = qm * qlo > 0
        lo, hi, qlo = (torch.where(same, mid, lo), torch.where(same, hi, mid),
                       torch.where(same, qm, qlo))
    return torch.tan(0.5 * (lo + hi)), valid


def five_point_roots_plain(M, basis):
    """H12's plain version: the candidate E's (..., 10, 3, 3), unit
    Frobenius norm, and their validity (..., 10) from the eliminated system
    M (..., 10, 10) (``-solve(A[..., :10], A[..., 10:])`` of the constraint
    rows) and the null-space basis (..., 4, 3, 3): B(z), its determinant,
    the real roots, then per root the null vector of B(z) from the row pair
    with the largest |v_3| and E = x X + y Y + z Z + W."""
    B = _z_matrix(M)                                       # (..., 3, 3, 5)
    roots, valid = _real_roots(_det_poly(B))
    zp = torch.pow(roots[..., None], device_constant(tuple(range(5)),
                                                     roots.device))
    Bz = torch.einsum("...rcp,...kp->...krc", B, zp)       # (..., 10, 3, 3)
    cands = torch.stack([torch.linalg.cross(Bz[..., 0, :], Bz[..., 1, :]),
                         torch.linalg.cross(Bz[..., 0, :], Bz[..., 2, :]),
                         torch.linalg.cross(Bz[..., 1, :], Bz[..., 2, :])],
                        dim=-2)                            # (..., 10, 3, 3)
    # the null vector from the row pair with the largest |v_3|
    pick = cands[..., 2].abs().argmax(dim=-1)
    v = torch.gather(cands, -2, pick[..., None, None].expand(
        pick.shape + (1, 3)))[..., 0, :]
    w = v[..., 2]
    ok_w = w.abs() > 1e-12
    w_safe = torch.where(ok_w, w, 1.0)
    x, y = v[..., 0] / w_safe, v[..., 1] / w_safe
    bs = basis[..., None, :, :, :]
    Es = (x[..., None, None] * bs[..., 0, :, :]
          + y[..., None, None] * bs[..., 1, :, :]
          + roots[..., None, None] * bs[..., 2, :, :] + bs[..., 3, :, :])
    flat = Es.reshape(Es.shape[:-2] + (9,))
    fro = torch.linalg.vector_norm(flat, dim=-1, keepdim=True)
    flat = flat / fro.clamp_min(1e-12)
    valid = valid & ok_w & torch.isfinite(flat).all(dim=-1)
    return flat.reshape(Es.shape), valid


def five_point_roots(M, basis):
    """:func:`five_point_roots_plain` on a CPU tensor; on a CUDA tensor the
    kernel H12 (``ops/fivepoint_cuda.five_point_roots``), one launch over
    the leading dimensions flattened, which raises rather than fall back."""
    if M.device.type == "cpu":
        return five_point_roots_plain(M, basis)
    lead = M.shape[:-2]
    Es, valid = fivepoint_cuda.five_point_roots(
        M.reshape(-1, 10, 10).contiguous(),
        basis.reshape(-1, 4, 3, 3).contiguous())
    return Es.reshape(lead + Es.shape[1:]), valid.reshape(lead + (-1,))


def epipolar_rows(x1, x2):
    """(..., n, 9) rows of x2^T E x1 = 0 for correspondences (..., n, 2)."""
    return torch.stack([
        x2[..., 0] * x1[..., 0], x2[..., 0] * x1[..., 1], x2[..., 0],
        x2[..., 1] * x1[..., 0], x2[..., 1] * x1[..., 1], x2[..., 1],
        x1[..., 0], x1[..., 1], torch.ones_like(x1[..., 0]),
    ], dim=-1)


def null_space_basis(x1, x2):
    """The (..., 4, 3, 3) basis X, Y, Z (free), W (affine) of the null
    space of 5 correspondences (..., 5, 2) each. Unique only up to a
    rotation in 4-D: LAPACK builds and cuSOLVER give different bases."""
    return basis_of_rows(epipolar_rows(x1, x2))


def basis_of_rows(a):
    """:func:`null_space_basis` of the epipolar rows (..., 5, 9)."""
    _, _, vt = svd(a, full_matrices=True)
    return vt[..., 5:9, :].flip(-2).reshape(vt.shape[:-2] + (4, 3, 3))


def eliminated_system(basis):
    """Gauss-Jordan of the constraint rows of a null-space basis (..., 4,
    3, 3): M = -A[..., :10]^-1 A[..., 10:] (..., 10, 10)."""
    A = _constraint_rows(basis)                            # (..., 10, 20)
    return -torch.linalg.solve_ex(A[..., :10], A[..., 10:]).result


def five_point_from_basis(basis):
    """Candidate E's (..., 10, 3, 3), unit Frobenius norm, and their
    validity (..., 10) from a null-space basis (..., 4, 3, 3)."""
    return five_point_roots(eliminated_system(basis), basis)


def five_point_candidates(x1, x2):
    """Essential-matrix candidates from 5 normalized correspondences
    (..., 5, 2) each: (Es (..., 10, 3, 3), valid (..., 10))."""
    return five_point_from_basis(null_space_basis(x1, x2))
