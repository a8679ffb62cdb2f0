"""The PyTorch port's pose filters against the JAX package's, on the CPU:
the rigid clique (membership equal), the median-residual outlier pass
(masks equal), the masked median (equal), and the residual and transform
helpers (float32, within an ulp of the coordinates). Cases follow
tests/test_pose.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvo_tpu.pose import kabsch as jkabsch
from openvo_tpu.pose import outlier as joutlier
from openvo_tpu.pose import rigid_clique as jclique
from openvo_tpu_torch.pose import kabsch, outlier, rigid_clique


def rotation(rvec):
    """Rodrigues' formula in float64."""
    th = np.linalg.norm(rvec)
    k = rvec / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def rigid_scene(rng, n=60, noise=0.0):
    src = rng.uniform(-5, 5, size=(n, 3))
    R = rotation(rng.normal(scale=0.2, size=3))
    t = rng.normal(scale=0.5, size=3)
    dst = src @ R.T + t + rng.normal(scale=noise, size=(n, 3))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return src.astype(np.float32), dst.astype(np.float32), T.astype(np.float32)


def cliques(prev_pts, pts, mask, thr):
    want = np.asarray(jax.jit(jclique.rigid_body_filter)(
        jnp.asarray(prev_pts), jnp.asarray(pts), jnp.asarray(mask), thr))
    rigid_clique.rigid_body_filter.syncs = 0
    got = rigid_clique.rigid_body_filter(
        torch.from_numpy(prev_pts), torch.from_numpy(pts),
        torch.from_numpy(mask), thr).numpy()
    assert got.dtype == np.int32
    return got, want


@pytest.mark.parametrize("seed", range(4))
def test_rigid_clique_matches_jax(seed):
    rng = np.random.default_rng(seed)
    src, dst, _ = rigid_scene(rng, n=30, noise=0.002)
    dst[:6] += rng.normal(scale=1.0, size=(6, 3)).astype(np.float32)
    got, want = cliques(src, dst, np.ones(30, bool), 0.05)
    np.testing.assert_array_equal(got, want)
    assert got[:6].sum() == 0 and got.sum() >= 20


@pytest.mark.parametrize("n,thr", [(512, 0.05), (300, 0.02)])
def test_rigid_clique_long_loop_matches_jax(n, thr):
    """Hundreds of iterations, so several batches between host checks, at
    the odometer's capacity; a tenth of the rows padded."""
    rng = np.random.default_rng(n)
    src, dst, _ = rigid_scene(rng, n=n, noise=0.01)
    dst[:40] += rng.normal(scale=0.5, size=(40, 3)).astype(np.float32)
    mask = rng.random(n) > 0.1
    got, want = cliques(src, dst, mask, thr)
    np.testing.assert_array_equal(got, want)
    iters = int(got.sum()) - 1
    assert iters > rigid_clique.CHECK_EVERY
    # a host check after each batch; the one after the last step stops it
    assert rigid_clique.rigid_body_filter.syncs == -(
        -iters // rigid_clique.CHECK_EVERY)


def test_rigid_clique_padding_excluded():
    rng = np.random.default_rng(9)
    src, dst, _ = rigid_scene(rng, n=20, noise=0.001)
    srcp = np.vstack([src, np.zeros((8, 3), np.float32)])
    dstp = np.vstack([dst, np.zeros((8, 3), np.float32)])
    mask = np.r_[np.ones(20, bool), np.zeros(8, bool)]
    got, want = cliques(srcp, dstp, mask, 0.05)
    np.testing.assert_array_equal(got, want)
    assert got[20:].sum() == 0 and got[:20].sum() >= 18


@pytest.mark.parametrize("rows", ["some", "all"])
def test_rigid_clique_nan_rows(rows):
    """A valid row with NaN coordinates is consistent with nothing. With
    every valid row NaN, JAX keeps its seed (index 0, invalid here) in the
    clique, and so does the port."""
    rng = np.random.default_rng(3)
    src, dst, _ = rigid_scene(rng, n=24, noise=0.001)
    mask = np.ones(24, bool)
    if rows == "some":
        src[[2, 11]] = np.nan
        dst[17] = np.nan
    else:
        src[:] = np.nan
        mask[0] = False
    got, want = cliques(src, dst, mask, 0.05)
    np.testing.assert_array_equal(got, want)
    if rows == "some":
        assert got[[2, 11, 17]].sum() == 0 and got.sum() >= 18


def test_rigid_clique_all_invalid_is_empty():
    rng = np.random.default_rng(4)
    src, dst, _ = rigid_scene(rng, n=16)
    got, want = cliques(src, dst, np.zeros(16, bool), 0.05)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 0


@pytest.mark.parametrize("first", ["a", "b"])
def test_rigid_clique_ties_go_to_the_first_maximum(first):
    """Two rigid groups of ten points, 40 apart along z, each moved its own
    way (so no pair across them keeps its distance): every point has ten
    consistencies. The seed and every pick take the first maximum, so the
    clique is the group listed first."""
    rng = np.random.default_rng(5)
    a = rng.uniform(-5, 5, (10, 3)).astype(np.float32)
    b = a[::-1] + np.float32([0, 0, 40])
    a2 = a + np.float32([0.3, 0, 0])
    b2 = b + np.float32([0, 0, 5])
    prev, cur = ((np.vstack([a, b]), np.vstack([a2, b2])) if first == "a"
                 else (np.vstack([b, a]), np.vstack([b2, a2])))
    got, want = cliques(prev, cur, np.ones(20, bool), 0.05)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.r_[np.ones(10), np.zeros(10)])


@pytest.mark.parametrize("n", [5, 6, 1, 0])
def test_masked_median_matches_jax(n):
    rng = np.random.default_rng(3)
    vals = rng.normal(size=16).astype(np.float32)
    mask = np.zeros(16, bool)
    mask[rng.permutation(16)[:n]] = True
    want = float(joutlier.masked_median(jnp.asarray(vals), jnp.asarray(mask)))
    got = float(outlier.masked_median(torch.from_numpy(vals),
                                      torch.from_numpy(mask)))
    assert got == want
    if n:
        assert got == np.float32(np.median(vals[mask]))


def test_masked_median_nan_in_a_valid_row():
    vals = np.array([1.0, np.nan, 3.0, 0.0], np.float32)
    for mask, nan in (([True, True, True, False], True),
                      ([True, False, True, True], False)):
        got = float(outlier.masked_median(torch.from_numpy(vals),
                                          torch.tensor(mask)))
        want = float(joutlier.masked_median(jnp.asarray(vals),
                                            jnp.asarray(mask)))
        assert np.isnan(got) == np.isnan(want) == nan
        if not nan:
            assert got == want == 1.0


@pytest.mark.parametrize("seed,noise,thr", [(4, 0.005, 0.1), (5, 0.05, 0.1),
                                            (6, 0.02, 0.01)])
def test_outlier_filter_matches_jax(seed, noise, thr):
    rng = np.random.default_rng(seed)
    src, dst, _ = rigid_scene(rng, n=40, noise=noise)
    dst[5] += 3.0
    dst[17] -= 2.5
    mask = rng.random(40) > 0.1
    want = np.asarray(jax.jit(joutlier.outlier_filter, static_argnums=3)(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), thr))
    got = outlier.outlier_filter(torch.from_numpy(src), torch.from_numpy(dst),
                                 torch.from_numpy(mask), thr).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[5] and not got[17] and got.sum() >= 10


def test_outlier_filter_nan_row_empties_the_mask():
    rng = np.random.default_rng(7)
    src, dst, _ = rigid_scene(rng, n=20, noise=0.01)
    src[3] = np.nan
    got = outlier.outlier_filter(torch.from_numpy(src), torch.from_numpy(dst),
                                 torch.ones(20, dtype=torch.bool), 0.1)
    assert not got.any()


def test_residuals_and_transform_points_match_jax():
    rng = np.random.default_rng(6)
    src, dst, T = rigid_scene(rng, n=10, noise=0.01)
    mask = np.arange(10) < 8
    np.testing.assert_allclose(
        kabsch.transform_points(torch.from_numpy(T),
                                torch.from_numpy(src)).numpy(),
        np.asarray(jkabsch.transform_points(jnp.asarray(T), jnp.asarray(src))),
        rtol=0, atol=2e-6)
    got = kabsch.residuals_relative(torch.from_numpy(T), torch.from_numpy(src),
                                    torch.from_numpy(dst),
                                    torch.from_numpy(mask)).numpy()
    want = np.asarray(jax.jit(jkabsch.residuals_relative)(
        jnp.asarray(T), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(mask)))
    # h_dst - T h_src cancels: the 4-term products, summed in another order
    # than XLA's, differ by an ulp of the coordinates (4.8e-7 at 5 m),
    # divided by ||h_dst|| >= 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.isinf(got[~mask]).all() and (got[mask] < 1e-2).all()
