"""Seeded inputs of the Kabsch fit and the small SVDs (H10 ``kabsch_fit``,
H11 ``jacobi_svd``), as numpy arrays: the tests on the CPU and on the card
and ``chip_smoke.py``'s kernel phase build their cases from these.

- :func:`clouds`: Kabsch's point clouds of several kinds (general, planar,
  3 and 10 valid points, collinear), which H10 fits;
- :func:`degenerate_clouds`: clouds where the fit meets its edge cases
  (fewer than 3 valid rows, NaN in a valid row, inf and NaN in invalid
  rows, planar, 3 points, no valid row);
- :func:`degenerate_3x3`: 3x3 matrices of rank 0-2, with equal singular
  values, negative determinants and extreme scales;
- :func:`five_point_rows`, :func:`essentials`: the five-point solver's
  (samples, 5, 9) epipolar rows of two-view points and rank-2 essential
  matrices, as the mono step gives them to H11.
"""

from __future__ import annotations

import numpy as np

CLOUD_KINDS = ("general", "planar", "three", "ten", "collinear")


def rotation(w):
    """Rodrigues: the rotation by the vector ``w`` (rad)."""
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def clouds(seed, count, points=64):
    """(src, dst, mask): ``count`` clouds of ``points`` float32 points, the
    kinds of CLOUD_KINDS in turn, dst a rotated, shifted and noisy copy."""
    rng = np.random.default_rng(seed)
    src = np.empty((count, points, 3), np.float32)
    dst = np.empty_like(src)
    mask = np.empty((count, points), bool)
    for i in range(count):
        kind = CLOUD_KINDS[i % len(CLOUD_KINDS)]
        s = rng.normal(0.0, 5.0, (points, 3)) * rng.uniform(0.01, 3.0, 3)
        s[:, 2] += 10.0
        if kind == "planar":
            s[:, 2] = 7.0
        if kind == "collinear":
            s = np.outer(rng.normal(0.0, 5.0, points), rng.normal(0, 1, 3))
        src[i] = s
        dst[i] = (s @ rotation(rng.normal(0.0, 0.3, 3)).T
                  + rng.normal(0.0, 1.0, 3)
                  + rng.normal(0.0, 0.05, s.shape))
        m = rng.random(points) < 0.7
        if kind in ("three", "ten"):
            m[:] = False
            m[rng.choice(points, 3 if kind == "three" else 10,
                         replace=False)] = True
        mask[i] = m
    return src, dst, mask


def degenerate_clouds(seed=0, points=64):
    """(src, dst, mask) of 7 clouds of :func:`clouds`' kinds made
    degenerate, in this order: 2 valid rows, NaN in a valid row, inf in
    src's and NaN in dst's invalid rows, planar (z constant), 3 valid
    rows, collinear, no valid row."""
    src, dst, mask = clouds(seed, 7, points)
    mask[0] = False
    mask[0, :2] = True
    src[1, np.flatnonzero(mask[1])[0], 1] = np.nan
    src[2][~mask[2]] = np.inf
    dst[2][~mask[2]] = np.nan
    src[3, :, 2] = np.float32(7.0)
    mask[4] = False
    mask[4, 5:8] = True
    src[5] = np.outer(np.arange(points, dtype=np.float32) - 20.0,
                      np.float32([0.3, -0.5, 0.8]))
    mask[6] = False
    return src, dst, mask


def degenerate_3x3(seed=0):
    """(k, 3, 3) float64 matrices where Jacobi meets its edge cases: zero,
    rank 1 and 2, the identity and other equal singular values, a
    permutation and a reflection (determinant -1), and scales near
    float64's ends."""
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    u, v = rng.normal(size=3), rng.normal(size=3)
    mats = [np.zeros((3, 3)), np.outer(u, v),
            np.outer(u, v) + np.outer(v, rng.normal(size=3)),
            np.eye(3), 2.0 * q, np.diag([2.0, 2.0, 1.0]),
            np.diag([3.0, 1.0, 1.0]), np.eye(3)[[1, 0, 2]],
            np.diag([1.0, 1.0, -1.0]) @ q,
            rng.normal(size=(3, 3)) * 1e-150,
            rng.normal(size=(3, 3)) * 1e150]
    return np.stack(mats)


def epipolar_rows(x1, x2):
    """(..., n, 9) rows of x2^T E x1 = 0 for correspondences (..., n, 2)
    (``openvo_tpu/pose/fivepoint.py:202-208``)."""
    return np.stack([x2[..., 0] * x1[..., 0], x2[..., 0] * x1[..., 1],
                     x2[..., 0], x2[..., 1] * x1[..., 0],
                     x2[..., 1] * x1[..., 1], x2[..., 1], x1[..., 0],
                     x1[..., 1], np.ones_like(x1[..., 0])], -1)


def two_view(rng, n):
    """n normalized correspondences of points 4-12 m in front of a camera
    moved by a random rotation (about 0.1 rad) and translation."""
    X = np.column_stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                         rng.uniform(4, 12, n)])
    Y = X @ rotation(rng.normal(0, 0.1, 3)).T + rng.normal(0, 1, 3)
    return X[:, :2] / X[:, 2:], Y[:, :2] / Y[:, 2:]


def five_point_rows(seed=0, samples=64):
    """(samples, 5, 9) float64 epipolar rows of 5 correspondences each."""
    rng = np.random.default_rng(seed)
    return np.stack([epipolar_rows(*two_view(rng, 5))
                     for _ in range(samples)])


def system_of_z_matrix(B):
    """(S, 10, 10) float32 eliminated systems M whose Nister z-matrix
    (``pose/fivepoint._z_matrix``) is B (S, 3, 3, 5): in each row pair and
    column group the top power's coefficient from the pair's second row,
    the others from its first; the entries B does not read are 0. Columns
    0 and 1 take powers z^0..z^3 (B[..., 4] must be 0 there), column 2
    z^0..z^4."""
    S = B.shape[0]
    M = np.zeros((S, 10, 10), np.float32)
    groups = [(2, 1, 0), (5, 4, 3), (9, 8, 7, 6)]
    for r, (pe, pf) in enumerate([(4, 5), (6, 7), (8, 9)]):
        for c, ks in enumerate(groups):
            for p, k in enumerate(ks):
                M[:, pe, k] = B[:, r, c, p]
            M[:, pf, ks[-1]] = -B[:, r, c, len(ks)]
    return M


# Triple, triple and fourfold roots (a, b, c) of the z-matrices of
# "clustered roots": the first two give ATen's float32 scan 13 sign changes
# on the H100, the others 9 or 10
CLUSTERED_ROOTS = [(1.5, -1.0, 1.5), (-1.0, 1.5, 1.5), (3.0, 0.5, 0.5),
                   (0.5, -0.5, -0.5), (-1.0, -1.0, -1.0), (2.0, 1.0, 1.5),
                   (1.5, 1.5, 0.75), (1.5, -2.0, -2.0)]


def z_matrices(kind, samples=8, seed=0):
    """(samples, 3, 3, 5) float32 diagonal z-matrices B(z) whose
    determinant has, by ``kind``:

    - "no real root": (z^2 + b)^4 times a positive factor, so no cell of
      the five-point scan changes sign;
    - "clustered roots": (z - a)^3 (z - b)^3 (z - c)^4 for the triples of
      CLUSTERED_ROOTS in turn, whose flat zeros give the float32 scan sign
      changes beyond the polynomial's own (rounding flips the sign of q
      cell after cell)."""
    rng = np.random.default_rng(seed)
    B = np.zeros((samples, 3, 3, 5), np.float32)
    for i in range(samples):
        if kind == "no real root":
            b = rng.uniform(0.2, 3.0)
            quad = np.array([b, 0.0, 1.0]) * rng.uniform(0.5, 2.0, 3)[:, None]
            diag = [quad[0], quad[1], np.convolve(quad[2], [b, 0.0, 1.0])]
        else:
            a, b, c = CLUSTERED_ROOTS[i % len(CLUSTERED_ROOTS)]
            diag = [np.poly([a] * 3)[::-1], np.poly([b] * 3)[::-1],
                    np.poly([c] * 4)[::-1]]
        for j, coef in enumerate(diag):
            B[i, j, j, :len(coef)] = coef
    return B


def essentials(seed=1, count=8):
    """(count, 3, 3) float64 essential matrices [t]x R (rank 2, singular
    values (s, s, 0))."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        t = rng.normal(0, 1, 3)
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]],
                       [-t[1], t[0], 0]])
        out.append(tx @ rotation(rng.normal(0, 0.2, 3)))
    return np.stack(out)
