"""Inputs that hold the two loop kernels to their plain versions on the
card: H7 ``speckle_keep`` (``ops/speckle_cuda.py``) and H8
``greedy_clique`` (``ops/clique_cuda.py``). ``chip_smoke.py``'s kernel
phase and ``tests/test_torch_kernels.py`` build their cases from these,
numpy arrays made from a seed.
"""

from __future__ import annotations

import numpy as np

INVALID = -16   # the x16 invalid disparity at minDisparity 0


def spiral(H=96, W=128):
    """(disp, valid): a 1 px wide spiral of one disparity, the shape that
    needs the most min-scan rounds in JAX (tests/test_sgbm.py's worst
    case), and two lone pixels in the corners."""
    d = np.full((H, W), INVALID, np.int16)
    top, bot, lft, rgt = 2, H - 3, 2, W - 3
    while lft < rgt - 4 and top < bot - 4:
        d[top, lft:rgt + 1] = 80
        d[top:bot + 1, rgt] = 80
        d[bot, lft + 2:rgt + 1] = 80
        d[top + 2:bot + 1, lft] = 80
        top, bot, lft, rgt = top + 2, bot - 2, lft + 2, rgt - 2
    d[1, 0] = 80
    d[H - 1, W - 1] = 80
    return d, d != INVALID


def islands(seed, H=64, W=96):
    """(disp, valid): blocky random disparities with noise and 10% holes,
    components of many sizes."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 4, (H // 8 + 1, W // 8 + 1)) * 40
    d = np.kron(coarse, np.ones((8, 8), np.int64))[:H, :W]
    d = (d + rng.integers(-8, 9, (H, W))).astype(np.int16)
    return d, rng.random((H, W)) > 0.1


def uniform(H, W, valid):
    """(disp, valid): one disparity everywhere, every pixel valid (one
    component) or none (all singletons)."""
    return np.full((H, W), 48, np.int16), np.full((H, W), valid)


def checkerboard(H, W, cell_h, cell_w):
    """(disp, valid): cells of cell_h x cell_w of two disparities that no
    edge joins, every pixel valid: each cell is a component of its own
    (4-connected, so diagonal cells do not touch), and cells that straddle
    the kernel's tile edges cross them in both directions."""
    y, x = np.mgrid[:H, :W]
    d = ((y // cell_h + x // cell_w) % 2 * 80).astype(np.int16)
    return d, np.ones((H, W), bool)


def staircase(H, W, step=7):
    """(disp, valid): diagonal bands ``step`` pixels wide of three
    disparities that no edge joins, 5% holes: long components that cross
    the kernel's tile rows and columns alike."""
    y, x = np.mgrid[:H, :W]
    d = ((x + y) // step % 3 * 40).astype(np.int16)
    holes = np.random.default_rng(H * W).random((H, W)) < 0.05
    return d, ~holes


def clouds(seed, B, N, valid=0.9, outliers=0.2, nan_rows=0, ties=0):
    """(prev_pts, pts, mask): B clouds of N points in a 20 m box moved by a
    rigid motion with 1 mm of noise, a share of ``outliers`` moved at
    random, ``nan_rows`` valid rows of NaN and ``ties`` rows repeating row
    0 (exact ties of the counts and the picks); float32 (B, N, 3) and
    bool (B, N)."""
    rng = np.random.default_rng(seed)
    prev = rng.uniform(-10, 10, (B, N, 3))
    a = rng.uniform(-0.1, 0.1, (B, 3))
    c, s = np.cos(a[:, 2]), np.sin(a[:, 2])
    R = np.zeros((B, 3, 3))
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = c, -s, s, c
    R[:, 2, 2] = 1
    pts = prev @ R.transpose(0, 2, 1) + rng.uniform(-1, 1, (B, 1, 3))
    pts += rng.normal(0, 1e-3, pts.shape)
    bad = rng.random((B, N)) < outliers
    pts[bad] += rng.uniform(-2, 2, (int(bad.sum()), 3))
    if ties:
        prev[:, 1:1 + ties] = prev[:, :1]
        pts[:, 1:1 + ties] = pts[:, :1]
    if nan_rows:
        pts[:, N - nan_rows:] = np.nan
    mask = rng.random((B, N)) < valid
    if nan_rows:
        mask[:, N - nan_rows:] = True
    return prev.astype(np.float32), pts.astype(np.float32), mask
