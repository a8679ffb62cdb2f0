"""The port's Kabsch fit, whose sums are fixed pairwise trees and whose 3x3
SVD is a fixed count of Jacobi sweeps with no host check
(``openvo_tpu_torch/pose/kabsch.py``, H10's plain version
``kabsch_fit_plain``), against the fit it replaces (``torch.linalg.svd``
and ``torch.linalg.det``, kept here as the oracle and the plain reference)
and against JAX's fit, on seeded clouds: general, planar, with inf and NaN
in the rows the mask drops, masked down to 3 and to 10 points, with NaN in
a valid row and with fewer than 3 valid rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvo_tpu.pose import kabsch as jkabsch
from openvo_tpu_torch.geometry.se3 import rt_to_T
from openvo_tpu_torch.pose import kabsch
from openvo_tpu_torch.tools import svd_cases

N_CLOUDS = 2000
N_POINTS = 64
KINDS = ("general", "planar", "nonfinite_rows", "three", "ten")


def kabsch_svd(src, dst, mask):
    """The fit before the Jacobi SVD: LAPACK's (or cuSOLVER's) SVD and
    determinant in float64, rounded once to float32."""
    w = mask.to(torch.float64)[..., None]
    n = torch.clamp_min(w.sum(-2), 1.0)
    src_c = torch.where(w > 0, src.to(torch.float64), 0.0)
    dst_c = torch.where(w > 0, dst.to(torch.float64), 0.0)
    mu_s = src_c.sum(-2) / n
    mu_d = dst_c.sum(-2) / n
    X = (src_c - mu_s[..., None, :]) * w
    Y = (dst_c - mu_d[..., None, :]) * w
    H = X.transpose(-1, -2) @ Y
    U, _, Vt = kabsch.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    one = torch.ones_like(d)
    R = V @ torch.diag_embed(torch.stack([one, one, d], -1)) @ Ut
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    few = (mask.sum(-1) < 3)[..., None, None]
    return torch.where(few, float("nan"), rt_to_T(R, t).to(torch.float32))


def rotation(rng):
    ang = rng.normal(0.0, 0.3, 3)
    th = np.linalg.norm(ang)
    k = ang / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def cloud(rng, kind):
    """(src, dst, mask) of one seeded cloud of ``kind``."""
    src = (rng.normal(0.0, 5.0, (N_POINTS, 3))
           * rng.uniform(0.01, 3.0, 3)).astype(np.float32)
    src[:, 2] += 10.0
    if kind == "planar":
        src[:, 2] = np.float32(7.0)
    dst = (src @ rotation(rng).T + rng.normal(0.0, 1.0, 3)
           + rng.normal(0.0, 0.05, src.shape)).astype(np.float32)
    mask = rng.random(N_POINTS) < 0.7
    if kind in ("three", "ten"):
        mask[:] = False
        mask[rng.choice(N_POINTS, 3 if kind == "three" else 10,
                        replace=False)] = True
    if kind == "nonfinite_rows":
        src[~mask] = np.inf
        dst[~mask] = np.nan
    return src, dst, mask


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(0)
    cs = [cloud(rng, KINDS[i % len(KINDS)]) for i in range(N_CLOUDS)]
    return tuple(torch.from_numpy(np.stack(a)) for a in zip(*cs))


def same_bits(a, b):
    return (a == b) | (torch.isnan(a) & torch.isnan(b))


@pytest.mark.parametrize("kind", KINDS)
def test_jacobi_fit_bit_equal_to_the_svd_fit(clouds, kind):
    sel = slice(KINDS.index(kind), None, len(KINDS))
    src, dst, mask = (x[sel] for x in clouds)
    got = kabsch.kabsch(src, dst, mask)
    want = kabsch_svd(src, dst, mask)
    assert torch.isfinite(got).all()
    differ = (~same_bits(got, want)).flatten(-2).any(-1)
    assert not differ.any(), f"{int(differ.sum())} of {len(got)} fits"


def jax_fit(src, dst, mask, x64):
    """JAX's fit of each cloud, in float32 as the JAX package runs it or,
    with ``x64``, the same function on float64 inputs."""
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        return np.asarray(jax.jit(jax.vmap(jkabsch.kabsch))(
            jnp.asarray(src.numpy(), dt), jnp.asarray(dst.numpy(), dt),
            jnp.asarray(mask.numpy())))


@pytest.mark.parametrize("kind", KINDS)
def test_jacobi_fit_matches_jax_in_float64(clouds, kind):
    """Every kind against JAX's function run in the port's precision."""
    sel = slice(KINDS.index(kind), None, len(KINDS))
    src, dst, mask = (x[sel] for x in clouds)
    got = kabsch.kabsch(src, dst, mask).numpy()
    np.testing.assert_allclose(got, jax_fit(src, dst, mask, True), rtol=0,
                               atol=1e-5)


def test_general_clouds_match_jax_in_float32(clouds):
    """The general clouds against JAX's float32 fit. On 3-point and planar
    clouds JAX's own float32 rounding moves its fit from the float64 one
    by more than 1e-5 (the stated tolerance of ROADMAP's float64 Kabsch),
    so those are held to JAX's function in float64 above."""
    sel = slice(KINDS.index("general"), None, len(KINDS))
    src, dst, mask = (x[sel] for x in clouds)
    got = kabsch.kabsch(src, dst, mask).numpy()
    np.testing.assert_allclose(got, jax_fit(src, dst, mask, False), rtol=0,
                               atol=1e-5)


def test_a_batch_gives_each_member_its_single_call(clouds):
    src, dst, mask = (x[:200] for x in clouds)
    batched = kabsch.kabsch(src, dst, mask)
    for i in range(len(src)):
        one = kabsch.kabsch(src[i], dst[i], mask[i])
        assert same_bits(batched[i], one).all(), i


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_non_finite_valid_row_gives_nan(bad):
    rng = np.random.default_rng(1)
    src, dst, mask = cloud(rng, "general")
    src[np.flatnonzero(mask)[0], 1] = bad
    T = kabsch.kabsch(torch.from_numpy(src), torch.from_numpy(dst),
                      torch.from_numpy(mask))
    assert torch.isnan(T[:3]).all()
    assert torch.equal(T[3], torch.tensor([0.0, 0.0, 0.0, 1.0]))


def test_fewer_than_three_points_gives_nan():
    rng = np.random.default_rng(2)
    src, dst, mask = cloud(rng, "general")
    mask[:] = False
    mask[:2] = True
    T = kabsch.kabsch(torch.from_numpy(src), torch.from_numpy(dst),
                      torch.from_numpy(mask))
    assert torch.isnan(T).all()


def fit_cases(case):
    """(src, dst, mask) of ``case``: svd_cases' seeded clouds of every kind
    but collinear (a rank-1 H: the rotation about the line is set by the
    noise alone, and two SVDs part there by 1e-5), or their degenerate
    ones, by what makes them so."""
    if case == "seeded":
        src, dst, mask = svd_cases.clouds(3, 40)
        keep = [i for i in range(40) if svd_cases.CLOUD_KINDS[
            i % len(svd_cases.CLOUD_KINDS)] != "collinear"]
        return src[keep], dst[keep], mask[keep]
    src, dst, mask = svd_cases.degenerate_clouds(5)
    i = {"NaN in a valid row": 1, "inf and NaN in invalid rows": 2,
         "planar": 3, "3 points": 4, "fewer than 3": [0, 6]}[case]
    i = [i] if isinstance(i, int) else i
    return src[i], dst[i], mask[i]


@pytest.mark.parametrize("case", ["seeded", "NaN in a valid row",
                                  "inf and NaN in invalid rows", "planar",
                                  "3 points", "fewer than 3"])
def test_kabsch_fit_plain_matches_jax(case):
    """H10's plain version against JAX's fit of the same float32 clouds run
    in float64 (the port's precision): within 1e-5, NaN where JAX's is
    (a NaN valid row: R and t; fewer than 3 rows: all of T)."""
    src, dst, mask = (torch.from_numpy(x) for x in fit_cases(case))
    got = kabsch.kabsch_fit_plain(src, dst, mask).numpy()
    want = jax_fit(src, dst, mask, True).astype(np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                               equal_nan=True)


@pytest.mark.parametrize("points", [16, 64, 300])
def test_kabsch_fit_plain_batch_is_one_call_per_cloud(points):
    """Each fit of a batch has its own call's bits, at powers of two and
    between two (the tree's padding), degenerate clouds too."""
    src, dst, mask = (torch.from_numpy(np.concatenate([x, y])) for x, y in
                      zip(svd_cases.clouds(points, 12, points),
                          svd_cases.degenerate_clouds(1, points)))
    batched = kabsch.kabsch_fit_plain(src, dst, mask)
    for i in range(len(src)):
        one = kabsch.kabsch_fit_plain(src[i:i + 1], dst[i:i + 1],
                                      mask[i:i + 1])
        assert same_bits(batched[i], one[0]).all(), i


def test_tree_sum_padding_leaves_the_sums_as_they_are():
    """The tree padded further with -0.0 (as H10's 256 threads pad N) gives
    the same bits, -0.0 sums included; its order is element i plus element
    i + h."""
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 37, 5)) * 10.0 ** np.arange(-4, 6)[:5])
    x[1, :, 2] = -0.0
    x[2, :, 4] = 0.0
    want = kabsch._tree_sum(x)
    for width in (64, 256, 1024):
        pad = torch.full((3, width - 37, 5), -0.0, dtype=x.dtype)
        assert same_bits(kabsch._tree_sum(torch.cat([x, pad], 1)),
                         want).all()
    assert torch.equal(torch.signbit(want[1, 2]), torch.tensor(True))
    y = torch.arange(4.0)[None, :, None] * torch.tensor([1.0, 1e16, 1.0, -1e16]
                                                        )[None, :, None]
    # (y0 + y2) + (y1 + y3) = (0 + 2) + (1e16 - 3e16)
    assert kabsch._tree_sum(y)[0, 0] == 2.0 + (1e16 - 3e16)
