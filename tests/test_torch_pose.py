"""The PyTorch port's pose code against the JAX package's, on the CPU:
the rigid clique (membership equal), the median-residual outlier pass
(masks equal), the masked median (equal), the residual and transform
helpers (float32, within an ulp of the coordinates); then se3's rt_to_T and
Rodrigues, the five-point solver stage by stage and as a whole, and the
RANSAC estimators fed JAX's uniforms, with their tolerances stated by each
test. Cases follow tests/test_pose.py, tests/test_se3.py and
tests/test_mono.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvo_tpu.geometry import se3 as jse3
from openvo_tpu.pose import fivepoint as jfp
from openvo_tpu.pose import kabsch as jkabsch
from openvo_tpu.pose import outlier as joutlier
from openvo_tpu.pose import ransac as jransac
from openvo_tpu.pose import rigid_clique as jclique
from openvo_tpu_torch.geometry import se3
from openvo_tpu_torch.pose import (fivepoint, kabsch, outlier, ransac,
                                   rigid_clique)


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
    # T h_src is XLA's bit for bit, but XLA's norm of the 4-vectors sums
    # their squares in an order of its own: an ulp of the coordinates
    # (4.8e-7 at 5 m), divided by ||h_dst|| >= 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.isinf(got[~mask]).all() and (got[mask] < 1e-2).all()


# --- se3: rt_to_T and Rodrigues (cases of tests/test_se3.py:69) -----------

def tt(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("batch", [(), (5,)])
def test_rt_to_T_matches_jax(batch):
    rng = np.random.default_rng(0)
    R = rng.normal(size=batch + (3, 3)).astype(np.float32)
    t = rng.normal(size=batch + (3,)).astype(np.float32)
    got = se3.rt_to_T(tt(R), tt(t)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jse3.rt_to_T(R, t)))


@pytest.mark.parametrize("case", ["random", "zero", "batch"])
def test_rodrigues_vec_to_R_matches_jax(case):
    """float32 sin/cos and the K @ K product, in ATen's order against
    XLA's: within 1e-6 of JAX's (entries of magnitude <= 1)."""
    rng = np.random.default_rng(1)
    rvec = {"random": rng.normal(size=3), "zero": np.zeros(3),
            "batch": rng.normal(scale=0.5, size=(6, 3))}[case]
    rvec = rvec.astype(np.float32)
    got = se3.rodrigues_vec_to_R(tt(rvec)).numpy()
    np.testing.assert_allclose(got, np.asarray(jse3.rodrigues_vec_to_R(rvec)),
                               rtol=0, atol=1e-6)
    if case == "zero":
        np.testing.assert_array_equal(got, np.eye(3, dtype=np.float32))
    else:
        ref = rotation(rvec.reshape(-1, 3)[0].astype(np.float64))
        np.testing.assert_allclose(got.reshape(-1, 3, 3)[0], ref, atol=1e-6)


# --- two-view scenes (tests/test_mono.py:21-34, :115-125) -----------------

def two_view(seed=0, n=200, noise=0.0, outliers=0):
    """Normalized correspondences of a random rigid two-view geometry."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -2, 4], [2, 2, 12], size=(n, 3))
    R = rotation(rng.normal(scale=0.05, size=3))
    t = np.array([0.5, 0.05, 0.1]) + rng.normal(scale=0.02, size=3)
    p2 = pts @ R.T + t
    x1 = pts[:, :2] / pts[:, 2:3] + rng.normal(scale=noise, size=(n, 2))
    x2 = p2[:, :2] / p2[:, 2:3] + rng.normal(scale=noise, size=(n, 2))
    if outliers:
        x2[:outliers] = rng.uniform(-0.5, 0.5, size=(outliers, 2))
    return x1.astype(np.float32), x2.astype(np.float32), R, t


def planar_two_view(seed=7, n=200):
    rng = np.random.default_rng(seed)
    pts = np.c_[rng.uniform(-3, 3, size=(n, 2)), np.full(n, 6.0)]
    t = np.array([0.4, 0.0, 0.1])
    p2 = pts + t
    return ((pts[:, :2] / pts[:, 2:3]).astype(np.float32),
            (p2[:, :2] / p2[:, 2:3]).astype(np.float32), np.eye(3), t)


def true_essential(R, t):
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    return E / np.linalg.norm(E)


def scene(name):
    kind, seed = name[:-1], int(name[-1])
    if kind == "planar":
        return planar_two_view(7 + seed)
    return two_view(seed, noise=1e-3 if kind == "noisy" else 0.0)


SCENES = ["random0", "random1", "random2", "noisy0", "noisy1", "planar0",
          "planar1"]


@functools.lru_cache(maxsize=None)
def jax_five_point(name):
    """JAX's five-point solver on the scene's first 5 points, stage by
    stage: its null-space basis, A, M, B, n, roots, and its candidates."""
    x1, x2 = (a[:5] for a in scene(name)[:2])

    def stages(x1, x2):
        a = jnp.stack([x2[:, 0] * x1[:, 0], x2[:, 0] * x1[:, 1], x2[:, 0],
                       x2[:, 1] * x1[:, 0], x2[:, 1] * x1[:, 1], x2[:, 1],
                       x1[:, 0], x1[:, 1], jnp.ones_like(x1[:, 0])], axis=1)
        basis = jnp.linalg.svd(a, full_matrices=True)[2][5:9][::-1].reshape(
            4, 3, 3)   # openvo_tpu/pose/fivepoint.py:201-210
        A = jfp._constraint_rows(basis)
        M = -jnp.linalg.solve(A[:, :10], A[:, 10:])
        B = jfp._z_matrix(M)
        n = jfp._det_poly(B)
        roots, valid = jfp._real_roots(n)
        Es, evalid = jfp.five_point_candidates(x1, x2)
        return dict(basis=basis, A=A, M=M, B=B, n=n, roots=roots,
                    valid=valid, Es=Es, evalid=evalid)

    out = jax.jit(stages)(jnp.asarray(x1), jnp.asarray(x2))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name", SCENES)
def test_five_point_stages_fed_jax_inputs(name):
    """Each stage fed JAX's own input: the constraint rows (a contraction
    of constant cubic forms in place of JAX's symbolic expansion) within
    2e-6 of max |A|; Nister's z-matrix bit-equal (differences only); the
    determinant polynomial within 64 float32 roundings of the magnitude of
    its terms (its minors cancel heavily; jnp.convolve's XLA order is not
    reproduced); the roots' validity equal and the roots within 1e-4
    relative + 1e-5 (the scan and 48 bisection steps over the same
    float32 grid, sin/cos/pow from another library)."""
    j = jax_five_point(name)
    A = fivepoint._constraint_rows(tt(j["basis"])).numpy()
    assert np.abs(A - j["A"]).max() <= 2e-6 * np.abs(j["A"]).max()
    np.testing.assert_array_equal(fivepoint._z_matrix(tt(j["M"])).numpy(),
                                  j["B"])
    n = fivepoint._det_poly(tt(j["B"])).numpy()
    absB = np.abs(j["B"]).astype(np.float64)
    # |n - n_jax| against the terms' magnitude: the det of |B| with every
    # product added (the minors' and cofactors' signs all positive)
    mag = sum(np.convolve(absB[0, c], np.convolve(absB[1, a], absB[2, b])
                          + np.convolve(absB[1, b], absB[2, a]))
              for c, (a, b) in enumerate([(1, 2), (0, 2), (0, 1)]))
    assert (np.abs(n - j["n"]) <= 64 * np.finfo(np.float32).eps * mag).all()
    roots, valid = (x.numpy() for x in fivepoint._real_roots(tt(j["n"])))
    np.testing.assert_array_equal(valid, j["valid"])
    assert valid.any()
    np.testing.assert_allclose(roots[valid], j["roots"][valid], rtol=1e-4,
                               atol=1e-5)


def essential_residuals(Es, x1, x2):
    """Per candidate: the largest epipolar residual |x2^T E x1| over the 5
    points, and the largest entry of det E and 2 E E^T E - tr(E E^T) E."""
    h1 = np.c_[x1, np.ones(len(x1))]
    h2 = np.c_[x2, np.ones(len(x2))]
    Es = Es.astype(np.float64)
    epi = np.abs(np.einsum("ni,kij,nj->kn", h2, Es, h1)).max(1)
    EEt = Es @ Es.transpose(0, 2, 1)
    tr = np.trace(EEt, axis1=1, axis2=2)[:, None, None]
    cubic = np.abs(2 * EEt @ Es - tr * Es).reshape(len(Es), -1).max(1)
    return np.maximum(np.maximum(epi, cubic), np.abs(np.linalg.det(Es)))


def pair_distance(Ea, Eb):
    """(len(Ea), len(Eb)) max-entry distances, up to sign."""
    d = np.abs(Ea[:, None] - Eb[None]).reshape(len(Ea), len(Eb), -1).max(-1)
    s = np.abs(Ea[:, None] + Eb[None]).reshape(len(Ea), len(Eb), -1).max(-1)
    return np.minimum(d, s)


@pytest.mark.parametrize("name", SCENES)
def test_five_point_candidates_match_jax_as_a_set(name):
    """The whole solver on the port's own null-space basis (LAPACK builds
    return other bases, so the candidates come in another order and with
    float32 noise), up to sign:
    - off the plane, at least 70% of either solver's valid candidates are
      essential matrices of the 5 points (epipolar, det and trace
      residuals below 2e-3; the others are spurious roots of the float32
      scan, JAX's as well as the port's: JAX's residuals reach 0.66, a
      quarter of its set on random2), and at least half of each set lies
      within 1e-3 of the other set;
    - exact scenes: the true E within 5e-3 of a candidate of both sets;
      noisy ones (1e-3 in normalized coordinates): the candidates nearest
      the true E within 1e-3 of each other;
    - on a plane the 5-point system is ill-posed in float32: both solvers'
      candidates have residuals near 1e-2 and the two sets differ by up to
      0.6, so only their residuals are bounded (median below 0.05). The
      5-point RANSAC recovers the plane's pose
      (test_ransac_essential_5pt_replays_jax)."""
    x1, x2, R, t = scene(name)
    j = jax_five_point(name)
    Es, valid = (x.numpy() for x in fivepoint.five_point_candidates(
        tt(x1[:5]), tt(x2[:5])))
    mine, theirs = Es[valid], j["Es"][j["evalid"]]
    assert len(mine) and len(theirs)
    res = [essential_residuals(c, x1[:5], x2[:5]) for c in (mine, theirs)]
    if name.startswith("planar"):
        assert all(np.median(r) < 0.05 for r in res)
        return
    assert all((r < 2e-3).mean() >= 0.7 for r in res)
    d = pair_distance(mine, theirs)
    assert (d.min(1) < 1e-3).mean() >= 0.5 and (d.min(0) < 1e-3).mean() >= 0.5
    E_true = true_essential(R, t)[None]
    near = [c[pair_distance(c, E_true)[:, 0].argmin()] for c in (mine,
                                                                 theirs)]
    if name.startswith("random"):
        assert all(pair_distance(c, E_true).min() < 5e-3 for c in (mine,
                                                                   theirs))
    else:
        assert pair_distance(near[0][None], near[1][None])[0, 0] < 1e-3


def test_five_point_from_jax_basis_matches_jax_slots():
    """Fed JAX's basis, the candidates come in JAX's order: on a general
    scene every valid slot equal within 1e-3, validity equal."""
    j = jax_five_point("random0")
    Es, valid = (x.numpy() for x in fivepoint.five_point_from_basis(
        tt(j["basis"])))
    np.testing.assert_array_equal(valid, j["evalid"])
    np.testing.assert_allclose(Es[valid], j["Es"][valid], rtol=0, atol=1e-3)


def test_svd_gives_nan_for_non_finite_input():
    """LAPACK under JAX propagates NaN; torch.linalg.svd raises. The port's
    svd returns NaN for that matrix alone."""
    a = np.random.default_rng(0).normal(size=(3, 5, 9)).astype(np.float32)
    a[1, 2, 3] = np.nan
    U, S, Vh = kabsch.svd(tt(a))
    assert torch.isnan(U[1]).all() and torch.isnan(S[1]).all()
    assert torch.isnan(Vh[1]).all()
    want = torch.linalg.svd(tt(a[0]))
    for got, ref in zip((U[0], S[0], Vh[0]), want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    js = np.asarray(jnp.linalg.svd(jnp.asarray(a[1]), compute_uv=False))
    assert np.isnan(js).all()


# --- the sampler ------------------------------------------------------------

@pytest.mark.parametrize("n,frac,k", [(512, 0.6, 5), (300, 0.3, 8),
                                      (64, 1.0, 3), (17, 0.5, 5)])
def test_sample_indices_equal_jax_choice(n, frac, k):
    """jax.random.choice's searchsorted(cumsum(p), cumsum(p)[-1] (1 - u))
    from the same uniforms: equal index for index (the cumulative sum in
    XLA:CPU's blocked order)."""
    rng = np.random.default_rng(n)
    mask = rng.random(n) < frac
    key = jax.random.PRNGKey(n)
    want = np.asarray(jransac._sample_indices(key, 64, k, n,
                                              jnp.asarray(mask)))
    u = np.asarray(jax.random.uniform(key, (64, k), dtype=jnp.float32))
    got = ransac.sample_indices(tt(u), tt(mask)).numpy()
    np.testing.assert_array_equal(got, want)


def test_own_sampler_draws_valid_rows_with_replacement():
    mask = np.zeros(100, bool)
    mask[[3, 7, 50, 99]] = True
    gen = torch.Generator().manual_seed(0)
    idx = ransac.sample_indices(ransac.uniforms(gen, (64, 5), "cpu"),
                                tt(mask)).numpy()
    assert set(np.unique(idx)) == {3, 7, 50, 99}
    assert any(len(set(row)) < 5 for row in idx)     # with replacement
    # the default draws come from a generator seeded 0
    u0 = ransac.uniforms(None, (64, 5), "cpu")
    torch.testing.assert_close(
        u0, torch.rand((64, 5), generator=torch.Generator().manual_seed(0)),
        rtol=0, atol=0)


def test_empty_mask_draws_index_zero():
    """All weights zero (a first or blank frame): index 0, as JAX's
    formula gives, with no raise."""
    u = torch.rand((16, 5), generator=torch.Generator().manual_seed(1))
    idx = ransac.sample_indices(u, torch.zeros(40, dtype=torch.bool))
    assert (idx == 0).all()
    want = np.asarray(jransac._sample_indices(jax.random.PRNGKey(0), 16, 5,
                                              40, jnp.zeros(40, bool)))
    assert (want == 0).all()


# --- RANSAC estimators on the same samples ---------------------------------

def test_sampson_error_matches_jax():
    """float32 products summed in another order: within 1e-5 relative of
    JAX's, plus 1e-10 (the inlier thresholds in use are 1e-6 and up)."""
    x1, x2, R, t = two_view(3, noise=1e-3)
    rng = np.random.default_rng(3)
    Es = np.stack([true_essential(R, t)]
                  + [rng.normal(size=(3, 3)) for _ in range(3)]).astype(
        np.float32)
    got = ransac.sampson_error(tt(Es), tt(x1), tt(x2)).numpy()
    want = np.stack([np.asarray(jransac.sampson_error(E, x1, x2))
                     for E in Es])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-10)


def test_eight_point_matches_jax_on_the_same_indices():
    """Batched over 16 samples of 8 points: E up to sign within 1e-4 where
    the 8 rows are distinct. A sample that repeats a row has a null space
    of two or more dimensions, from which each SVD build returns its own
    vector: there both results are only held to the essential spectrum."""
    x1, x2, _, _ = two_view(4, n=60, noise=1e-3)
    idx = np.random.default_rng(4).integers(0, 60, (16, 8))
    got = ransac._eight_point(tt(x1[idx]), tt(x2[idx])).numpy()
    want = np.asarray(jax.jit(jax.vmap(jransac._eight_point))(
        jnp.asarray(x1[idx]), jnp.asarray(x2[idx])))
    distinct = np.array([len(set(r)) == 8 for r in idx])
    assert 0 < distinct.sum() < 16
    d = np.diagonal(pair_distance(got, want))
    assert (d[distinct] < 1e-4).all(), d
    for E in (got, want):
        sv = np.linalg.svd(E.astype(np.float64), compute_uv=False)
        np.testing.assert_allclose(sv, [[1, 1, 0]] * 16, atol=1e-5)


@pytest.mark.parametrize("name", ["random0", "noisy1", "planar0"])
def test_recover_pose_matches_jax(name):
    """The candidate with the most cheirality support: R and t within 1e-4
    of JAX's, the support mask equal. R1 and R2 can swap between SVD
    builds, so the choice is compared by its result, not its slot."""
    x1, x2, R, t = scene(name)
    E = true_essential(R, t).astype(np.float32)
    mask = np.random.default_rng(0).random(len(x1)) > 0.1
    Rg, tg, good = (x.numpy() for x in ransac.recover_pose(
        tt(E), tt(x1), tt(x2), tt(mask)))
    Rw, tw, gw = (np.asarray(x) for x in jax.jit(jransac.recover_pose)(
        E, x1, x2, mask))
    np.testing.assert_allclose(Rg, Rw, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tg, tw, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(good, gw)
    assert good.sum() > 0.8 * mask.sum()


def test_ransac_rigid_matches_jax():
    """The same 64 samples (JAX's uniforms): the transform within 1e-4,
    the inliers equal; outliers rejected (tests/test_mono.py:91)."""
    rng = np.random.default_rng(4)
    src, dst, T = rigid_scene(rng, n=64)
    dst[:10] += rng.uniform(1, 2, size=(10, 3)).astype(np.float32)
    mask = np.ones(64, bool)
    key = jax.random.PRNGKey(1)
    u = np.asarray(jax.random.uniform(key, (64, 3), dtype=jnp.float32))
    Tw, iw, nw = jransac.ransac_rigid(jnp.asarray(src), jnp.asarray(dst),
                                      jnp.asarray(mask), key, iters=64)
    Tg, ig, ng = ransac.ransac_rigid(tt(src), tt(dst), tt(mask), tt(u),
                                     iters=64)
    np.testing.assert_allclose(Tg.numpy(), np.asarray(Tw), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ig.numpy(), np.asarray(iw))
    assert int(ng) == int(nw) and ig[:10].sum() == 0


def test_ransac_essential_8pt_matches_jax():
    x1, x2, _, _ = two_view(2, n=200, noise=1e-4, outliers=40)
    mask = np.ones(200, bool)
    key = jax.random.PRNGKey(0)
    u = np.asarray(jax.random.uniform(key, (128, 8), dtype=jnp.float32))
    Ew, iw, _ = jransac.ransac_essential(jnp.asarray(x1), jnp.asarray(x2),
                                         jnp.asarray(mask), key, iters=128,
                                         inlier_threshold=1e-5)
    Eg, ig, _ = ransac.ransac_essential(tt(x1), tt(x2), tt(mask), tt(u),
                                        iters=128, inlier_threshold=1e-5)
    assert pair_distance(Eg.numpy()[None], np.asarray(Ew)[None])[0, 0] < 1e-4
    np.testing.assert_array_equal(ig.numpy(), np.asarray(iw))


@pytest.mark.parametrize("name,outliers", [("random", 30), ("planar", 0)])
def test_ransac_essential_5pt_replays_jax(name, outliers):
    """Fed JAX's uniforms, the port draws JAX's indices exactly; the
    candidates then come from its own basis, so E agrees up to sign within
    2e-3 and the inlier masks in all but 1% of the rows (points on the
    threshold); the pose is JAX's (tests/test_mono.py:139-170)."""
    if name == "planar":
        x1, x2, R, t = planar_two_view()
        thr = 1e-6
    else:
        x1, x2, R, t = two_view(11, n=200, noise=1e-4, outliers=outliers)
        thr = 1e-5
    n = len(x1)
    mask = np.ones(n, bool)
    key = jax.random.PRNGKey(1)
    u = np.asarray(jax.random.uniform(key, (64, 5), dtype=jnp.float32))
    np.testing.assert_array_equal(
        ransac.sample_indices(tt(u), tt(mask)).numpy(),
        np.asarray(jransac._sample_indices(key, 64, 5, n, jnp.asarray(mask))))
    Ew, iw, nw = jransac.ransac_essential_5pt(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), key, iters=64,
        inlier_threshold=thr)
    Eg, ig, ng = ransac.ransac_essential_5pt(tt(x1), tt(x2), tt(mask), tt(u),
                                             iters=64, inlier_threshold=thr)
    assert pair_distance(Eg.numpy()[None], np.asarray(Ew)[None])[0, 0] < 2e-3
    assert (ig.numpy() != np.asarray(iw)).mean() <= 0.01
    Rg, tg, _ = ransac.recover_pose(Eg, tt(x1), tt(x2), ig)
    np.testing.assert_allclose(Rg.numpy(), R, atol=0.02)
    t_dir = t / np.linalg.norm(t)
    assert min(np.linalg.norm(tg.numpy() - t_dir),
               np.linalg.norm(tg.numpy() + t_dir)) < 0.1
