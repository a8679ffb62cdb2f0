"""Nister's five-point solver of the plain reference, batched over the
samples of one frame:

1. null space: the SVD (``svd.py``) of the 5x9 epipolar rows gives the
   basis X, Y, Z, W with E = x X + y Y + z Z + W;
2. the 10 cubic constraints (det E = 0 and 2 E E^T E - tr(E E^T) E = 0) as
   a (10, 20) coefficient matrix over Nister's monomial order, from a
   constant (10, 9, 9, 9) tensor of cubic forms contracted with the basis;
3. Gauss-Jordan (one 10x10 solve) and Nister's row combinations reduce
   the system to B(z) [x, y, 1]^T = 0, n(z) = det B(z);
4. real roots by a sign-change scan over theta = atan(z) (512 cells), then
   48 bisection steps;
5. back-substitution per root by null-vector cross products: up to 10
   candidate E's a sample, invalid slots masked.

Frozen copy of the plain versions in ``openvo_tpu_torch/pose/fivepoint.py``
of the commit that added the monocular cell: plain PyTorch, no kernel, no
import of the program, so that a later change to the program cannot move
it.

``low=True`` is the control: each stage's result (basis, constraint rows,
eliminated system, B(z), n(z), roots, candidates) held in bfloat16, the
next precision below the configuration's float32.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from vobench.reference.svd import svd
from vobench.reference.util import device_constant

# Nister's 20-monomial order (x, y, z exponents)
_MONOMIALS = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_MONO_INDEX = {m: i for i, m in enumerate(_MONOMIALS)}
# E = x X + y Y + z Z + 1 W: the exponent each basis slot adds
_SLOT_EXP = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]

N_GRID = 512
N_BISECT = 48
MAX_ROOTS = 10


def held(x, low: bool):
    """``x`` rounded to bfloat16 and back where ``low`` (the control)."""
    return x.to(torch.bfloat16).to(x.dtype) if low else x


def cubic_forms():
    """(10, 9, 9, 9) float32: constraint j = sum C[j, a, b, c] E_a E_b E_c
    over the row-major entries of E (det E first, then 2 E E^T E - tr(E
    E^T) E row by row)."""
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


def monomial_map():
    """(64, 20) float32: the monomial of each ordered triple of basis
    slots."""
    S = np.zeros((64, 20), np.float32)
    for i, (m1, m2, m3) in enumerate(itertools.product(range(4), repeat=3)):
        e = tuple(map(sum, zip(_SLOT_EXP[m1], _SLOT_EXP[m2], _SLOT_EXP[m3])))
        S[i, _MONO_INDEX[e]] = 1.0
    return S


def constraint_rows(basis):
    """(..., 10, 20) coefficients of the 10 cubic constraints of a basis
    (..., 4, 3, 3)."""
    C = device_constant(cubic_forms, basis.device)
    S = device_constant(monomial_map, basis.device)
    b = basis.reshape(basis.shape[:-2] + (9,))
    t = torch.einsum("jabc,...nc->...jabn", C, b)
    t = torch.einsum("...jabn,...mb->...jamn", t, b)
    t = torch.einsum("...jamn,...la->...jlmn", t, b)    # (..., 10, 4, 4, 4)
    return t.reshape(t.shape[:-3] + (64,)) @ S


def z_index():
    """(2, 45) indices into M's 100 entries plus a zero at 100 of
    B[r, c, p] = M[IA] - M[IB]."""
    zero = 100
    ia = np.full((3, 3, 5), zero, np.int64)
    ib = np.full((3, 3, 5), zero, np.int64)
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


def z_matrix(M):
    """Nister's (..., 3, 3, 5) z-polynomial matrix B(z) ([row][col][z
    power]) of the eliminated system (..., 10, 10): rows <e> - z<f>, <g>
    - z<h>, <i> - z<j>."""
    ia, ib = device_constant(z_index, M.device, torch.int64)
    flat = torch.cat([M.reshape(M.shape[:-2] + (100,)),
                      M.new_zeros(M.shape[:-2] + (1,))], dim=-1)
    return (flat[..., ia] - flat[..., ib]).reshape(M.shape[:-2] + (3, 3, 5))


def conv(a, v):
    """Full convolution of coefficient vectors (..., n) and (..., m): the
    longer one padded, the taps of the other reversed, summed tap by
    tap."""
    if v.shape[-1] > a.shape[-1]:
        a, v = v, a
    n, m = a.shape[-1], v.shape[-1]
    pad = torch.nn.functional.pad(a, (m - 1, m - 1))
    out = pad[..., :n + m - 1] * v[..., m - 1:]
    for k in range(1, m):
        out = out + pad[..., k:k + n + m - 1] * v[..., m - 1 - k:m - k]
    return out


def det_poly(B):
    """det of the (..., 3, 3, 5) z-polynomial matrix: (..., 13)
    coefficients, by the minors of rows 1 and 2."""
    c0 = device_constant((1, 0, 0), B.device, torch.int64)
    c1 = device_constant((2, 2, 1), B.device, torch.int64)
    r1, r2 = B[..., 1, :, :], B[..., 2, :, :]
    minors = (conv(r1.index_select(-2, c0), r2.index_select(-2, c1))
              - conv(r1.index_select(-2, c1), r2.index_select(-2, c0)))
    t = conv(B[..., 0, :, :], minors)                       # (..., 3, 13)
    return t[..., 0, :] - t[..., 1, :] + t[..., 2, :]


def theta_grid():
    """The scan's theta grid over (-pi/2, pi/2), float32, as jnp.linspace
    computes it."""
    eps = 1e-4
    lo, hi = np.float32(-np.pi / 2 + eps), np.float32(np.pi / 2 - eps)
    h = np.arange(N_GRID - 1, dtype=np.float32) / np.float32(N_GRID - 1)
    g = lo * (np.float32(1) - h) + hi * h
    return np.append(g, hi).astype(np.float32)


def real_roots(n_coeffs):
    """Up to 10 real roots (..., 10) and their validity of the polynomials
    (..., 13), by z = tan(theta): q(theta) = sum_i c_i sin^i cos^(12-i)
    has the sign pattern of n(z). The first 10 sign-change cells of the
    grid in ascending order, each bisected."""
    deg = n_coeffs.shape[-1] - 1
    scale = n_coeffs.abs().amax(dim=-1, keepdim=True) + 1e-30
    c = n_coeffs / scale
    dev = c.device
    exps = device_constant(tuple(range(deg + 1)), dev)

    def q(theta):
        s, co = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
        return (c[..., None, :] * torch.pow(s, exps)
                * torch.pow(co, deg - exps)).sum(-1)

    grid = device_constant(theta_grid, dev)
    qs = q(grid.expand(c.shape[:-1] + (N_GRID,)))
    sc = qs[..., :-1] * qs[..., 1:] < 0
    idx = torch.sort((~sc).to(torch.uint8), dim=-1,
                     stable=True).indices[..., :MAX_ROOTS]
    valid = torch.gather(sc, -1, idx)
    lo = grid[idx]
    hi = grid[(idx + 1).clamp_max(N_GRID - 1)]
    qlo = q(lo)
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        qm = q(mid)
        same = qm * qlo > 0
        lo, hi, qlo = (torch.where(same, mid, lo), torch.where(same, hi, mid),
                       torch.where(same, qm, qlo))
    return torch.tan(0.5 * (lo + hi)), valid


def epipolar_rows(x1, x2):
    """(..., n, 9) rows of x2^T E x1 = 0 for correspondences (..., n, 2)."""
    return torch.stack([
        x2[..., 0] * x1[..., 0], x2[..., 0] * x1[..., 1], x2[..., 0],
        x2[..., 1] * x1[..., 0], x2[..., 1] * x1[..., 1], x2[..., 1],
        x1[..., 0], x1[..., 1], torch.ones_like(x1[..., 0]),
    ], dim=-1)


def null_space_basis(x1, x2, low: bool = False):
    """The (..., 4, 3, 3) basis X, Y, Z, W of the null space of 5
    correspondences (..., 5, 2): the last four right singular vectors,
    last first."""
    _, _, vt = svd(epipolar_rows(x1, x2), low)
    return vt[..., 5:9, :].flip(-2).reshape(vt.shape[:-2] + (4, 3, 3))


def from_basis(basis, low: bool = False):
    """Candidate E's (..., 10, 3, 3), unit Frobenius norm, and their
    validity (..., 10) from a null-space basis (..., 4, 3, 3)."""
    basis = held(basis, low)
    A = held(constraint_rows(basis), low)
    M = held(-torch.linalg.solve_ex(A[..., :10], A[..., 10:]).result, low)
    B = held(z_matrix(M), low)
    roots, valid = real_roots(held(det_poly(B), low))
    roots = held(roots, low)
    zp = torch.pow(roots[..., None], device_constant(tuple(range(5)),
                                                     roots.device))
    Bz = torch.einsum("...rcp,...kp->...krc", B, zp)       # (..., 10, 3, 3)
    cands = torch.stack([torch.linalg.cross(Bz[..., 0, :], Bz[..., 1, :]),
                         torch.linalg.cross(Bz[..., 0, :], Bz[..., 2, :]),
                         torch.linalg.cross(Bz[..., 1, :], Bz[..., 2, :])],
                        dim=-2)
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
    flat = held(flat / fro.clamp_min(1e-12), low)
    valid = valid & ok_w & torch.isfinite(flat).all(dim=-1)
    return flat.reshape(Es.shape), valid


def candidates(x1, x2, low: bool = False):
    """Essential-matrix candidates from 5 normalized correspondences
    (..., 5, 2) each: (Es (..., 10, 3, 3), valid (..., 10))."""
    return from_basis(null_space_basis(x1, x2, low), low)
