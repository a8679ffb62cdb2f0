"""The small SVDs of the port's pose fits (``openvo_tpu_torch/pose/kabsch.py``)
against JAX's, on the CPU:

- H11's plain version ``jacobi_svd_plain`` (a batched one-sided Jacobi SVD
  in float64) against ``jnp.linalg.svd`` in float64 on the shapes the mono
  step gives it: the five-point solver's (64, 5, 9) epipolar rows of
  seeded two-view points (float32, whose null-space basis must be JAX's
  own float32 one, bit for bit, on these and on the bench corridor's
  samples), (8, 3, 3) rank-2 essential matrices, the refit's 9x9 Grams of
  the bench corridor's matches (tests/data/mono_stages.npz), zero and NaN
  matrices;
- the round-robin order of H11's sweeps (``kabsch.jacobi_rounds``): every
  pair once a sweep, in disjoint rounds, and on 3x3 matrices the bits of
  the cyclic order (a reference kept here);
- the operators ``openvo_torch::kabsch_fit`` (H10) and
  ``openvo_torch::jacobi_svd`` (H11) on the CPU: their plain versions;
- ``kabsch.svd`` on the card's route (``card_svd_route``) and the mono
  step traced by ``make_fx`` on it, with no host read.

The kernels themselves run on the card (tests/test_torch_kernels.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from openvo_tpu.pose import ransac as jransac
from openvo_tpu_torch.models import mono_odometer as mono
from openvo_tpu_torch.pose import kabsch, ransac
from openvo_tpu_torch.tools import svd_cases

import test_torch_kabsch as tk

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "mono_stages.npz")
# Against LAPACK in float64: singular values within 1e-10 of the largest;
# the projector onto a null space (or onto the least singular vector)
# within 1e-9; a column of V for a singular value set apart from the others
# by a relative gap of 1e-6 within 1e-9 up to sign. Both are backward
# stable, so they part by about eps |A| / gap: 1e-13 at the Grams' least
# gap, 1e-15 elsewhere (measured). A wide float32 matrix goes through
# LAPACK's float32 LQ first, as JAX's SVD does: its singular values within
# WIDE_S_TOL of the largest (float32 rounding of L; measured 2e-7), V
# orthonormal within WIDE_ORTH_TOL (Q's float32 rows; measured 5e-7), and
# its null-space basis JAX's float32 one exactly.
S_TOL = 1e-10
PROJ_TOL = 1e-9
COL_TOL = 1e-9
DISTINCT = 1e-6
WIDE_S_TOL = 2e-6
WIDE_ORTH_TOL = 2e-6


def corridor_grams():
    with np.load(DATA) as z:
        out = []
        for f in (28, 61):
            a = svd_cases.epipolar_rows(z[f"f{f}_x1"], z[f"f{f}_x2"]).astype(
                np.float64)
            a = a * z[f"f{f}_inliers"][:, None]
            out.append(a.T @ a)
    return np.stack(out)


CASES = {"five-point rows": svd_cases.five_point_rows,
         "essential": svd_cases.essentials, "corridor grams": corridor_grams}


def jax_svd(a):
    with jax.enable_x64(True):
        U, S, Vh = jnp.linalg.svd(jnp.asarray(a, jnp.float64),
                                  full_matrices=True)
        return np.asarray(U), np.asarray(S), np.asarray(Vh)


def null_projector(v):
    return v @ np.swapaxes(v, -1, -2)


@pytest.mark.parametrize("case", ["essential", "corridor grams"])
def test_jacobi_svd_plain_matches_lapack(case):
    a = CASES[case]()
    n = a.shape[-1]
    S, V, U, sweeps = (x.numpy() for x in kabsch.jacobi_svd_plain(
        torch.from_numpy(a)))
    Uj, Sj, Vhj = jax_svd(a)
    Vj = np.swapaxes(Vhj, -1, -2)
    top = Sj[:, :1]
    assert (np.abs(S - Sj) <= S_TOL * top).all()
    np.testing.assert_allclose(np.swapaxes(V, -1, -2) @ V,
                               np.broadcast_to(np.eye(n), V.shape),
                               rtol=0, atol=1e-13)
    # the null space: the columns of (numerically) zero singular value,
    # and the least singular vector of the Grams
    rank = 2 if case == "essential" else n - 1
    np.testing.assert_allclose(null_projector(V[..., rank:]),
                               null_projector(Vj[..., rank:]), rtol=0,
                               atol=PROJ_TOL)
    if case == "essential":
        # U's third column is u_1 x u_2: E's left null vector up to sign
        np.testing.assert_allclose(null_projector(U[..., 2:]),
                                   null_projector(Uj[..., 2:]), rtol=0,
                                   atol=PROJ_TOL)
        np.testing.assert_allclose(U @ (S[:, :, None] * np.swapaxes(
            V, -1, -2)), a, rtol=0, atol=1e-12)
    for b in range(len(a)):
        for j in range(rank):
            gaps = np.abs(np.delete(Sj[b], j) - Sj[b, j]) / top[b]
            if gaps.min() > DISTINCT:
                d = min(np.abs(V[b, :, j] - Vj[b, :, j]).max(),
                        np.abs(V[b, :, j] + Vj[b, :, j]).max())
                assert d <= COL_TOL, (b, j, d)
    assert (1 <= sweeps).all() and (sweeps <= kabsch.JACOBI_MAX_SWEEPS).all()


def corridor_five_point_rows():
    """The five-point rows of the bench corridor's frames 28 and 61 (JAX's
    samples of their matches), (128, 5, 9) float32."""
    with np.load(DATA) as z:
        return np.concatenate([svd_cases.epipolar_rows(
            z[f"f{f}_x1"][z[f"f{f}_idx"]], z[f"f{f}_x2"][z[f"f{f}_idx"]])
            for f in (28, 61)]).astype(np.float32)


@pytest.mark.parametrize("rows", ["seeded", "corridor"])
def test_wide_matrix_has_jax_null_basis(rows):
    """The five-point rows (float32, 5x9): the null space in JAX's own
    float32 basis, bit for bit (LAPACK's sgesdd under jnp.linalg.svd),
    the singular values and the rest of V within float32 rounding of JAX's
    float64 SVD."""
    a = (svd_cases.five_point_rows().astype(np.float32) if rows == "seeded"
         else corridor_five_point_rows())
    S, V, U, sweeps = (x.numpy() for x in kabsch.jacobi_svd_plain(
        torch.from_numpy(a)))
    vt = np.asarray(jax.jit(jax.vmap(
        lambda x: jnp.linalg.svd(x, full_matrices=True)[2]))(a))
    np.testing.assert_array_equal(np.swapaxes(V[..., 5:], -1, -2)
                                  .astype(np.float32), vt[:, 5:])
    _, Sj, _ = jax_svd(a.astype(np.float64))
    assert (np.abs(S[:, :5] - Sj) <= WIDE_S_TOL * Sj[:, :1]).all()
    assert (S[:, 5:] == 0).all() and U.shape == (len(a), 0, 0)
    np.testing.assert_allclose(np.swapaxes(V, -1, -2) @ V,
                               np.broadcast_to(np.eye(9), V.shape), rtol=0,
                               atol=WIDE_ORTH_TOL)
    # the row space as JAX's float32 SVD spans it (both from LAPACK's Q)
    np.testing.assert_allclose(null_projector(V[..., :5]),
                               null_projector(np.swapaxes(vt[:, :5], -1, -2)
                                              .astype(np.float64)), rtol=0,
                               atol=WIDE_ORTH_TOL)
    assert (1 <= sweeps).all() and (sweeps <= kabsch.JACOBI_MAX_SWEEPS).all()


def test_jacobi_svd_plain_zero_and_nan():
    """A zero matrix: S 0, V the identity, one sweep that rotates nothing,
    as LAPACK's; a NaN matrix through ``svd`` on the card's route: NaN in
    U, S and Vh, as JAX gives."""
    S, V, U, sweeps = kabsch.jacobi_svd_plain(torch.zeros((2, 5, 9)))
    assert (S == 0).all() and torch.equal(V, torch.eye(9, dtype=torch.float64)
                                          .expand(2, 9, 9))
    assert sweeps.tolist() == [1, 1] and U.shape == (2, 0, 0)
    Uj, Sj, _ = jax_svd(np.zeros((5, 9)))
    assert (Sj == 0).all()
    a = np.random.default_rng(0).normal(size=(3, 3, 3)).astype(np.float32)
    a[1, 0, 2] = np.nan
    with kabsch.card_svd_route():
        U, S, Vh = kabsch.svd(torch.from_numpy(a))
    assert torch.isnan(U[1]).all() and torch.isnan(S[1]).all()
    assert torch.isnan(Vh[1]).all() and torch.isfinite(U[0::2]).all()
    with jax.enable_x64(True):
        assert np.isnan(np.asarray(jnp.linalg.svd(a[1])[1])).all()


def test_jacobi_svd_plain_batch_gives_each_member_its_own_call():
    a = torch.from_numpy(np.concatenate([svd_cases.five_point_rows(2, 6),
                                         np.zeros((1, 5, 9))])
                         .astype(np.float32))
    batched = kabsch.jacobi_svd_plain(a)
    for i in range(len(a)):
        for got, one in zip(batched, kabsch.jacobi_svd_plain(a[i:i + 1])):
            assert torch.equal(got[i], one[0]), i


@pytest.mark.parametrize("case", ["essential", "corridor grams"])
def test_a_done_matrix_is_left_as_it_is(monkeypatch, case):
    """A matrix whose sweep rotated nothing ends with the same bits
    whether the sweeps stop there (as H11 stops it) or run on to the cap
    (as the plain version runs the batch)."""
    a = torch.from_numpy(CASES[case]())
    full = kabsch.jacobi_svd_plain(a)
    assert (full[3] < kabsch.JACOBI_MAX_SWEEPS).all()
    for i, n in enumerate(full[3].tolist()):
        monkeypatch.setattr(kabsch, "JACOBI_MAX_SWEEPS", n)
        for got, want in zip(kabsch.jacobi_svd_plain(a[i:i + 1]), full):
            assert torch.equal(got[0], want[i]), (i, n)


def test_rotation_operator_on_the_cpu_is_the_plain_fit():
    """The operators on CPU tensors: ``openvo_torch::kabsch_fit`` is
    ``kabsch_fit_plain`` (seeded and degenerate clouds), its rotation
    ``rotation_3x3_plain`` of the cross-covariance; ``jacobi_svd`` is
    ``jacobi_svd_plain``."""
    rng = np.random.default_rng(0)
    cs = [tk.cloud(rng, tk.KINDS[i % len(tk.KINDS)]) for i in range(200)]
    src, dst, mask = (torch.from_numpy(np.stack(x)) for x in zip(*cs))
    deg = [torch.from_numpy(x) for x in svd_cases.degenerate_clouds()]
    src, dst, mask = (torch.cat([x, y]) for x, y in zip((src, dst, mask),
                                                        deg))
    got = torch.ops.openvo_torch.kabsch_fit(src, dst, mask)
    assert tk.same_bits(got, kabsch.kabsch_fit_plain(src, dst, mask)).all()
    H, _, _, count = kabsch.cross_covariance(src, dst, mask)
    ok = torch.isfinite(H).all(-1).all(-1) & (count >= 3)
    V, Ut = kabsch.rotation_3x3_plain(H[ok])
    torch.testing.assert_close(got[ok][:, :3, :3],
                               (V @ Ut).to(torch.float32), rtol=0,
                               atol=1e-6)
    a = torch.from_numpy(svd_cases.five_point_rows(4, 3).astype(np.float32))
    for got, want in zip(torch.ops.openvo_torch.jacobi_svd(a),
                         kabsch.jacobi_svd_plain(a)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 9])
def test_round_robin_rotates_every_pair_once_a_sweep(n):
    """H11's order: every pair p < q once a sweep, each round's pairs
    disjoint, n' - 1 rounds (n' = n rounded up to even), and for n = 3 the
    cyclic order (0, 1), (0, 2), (1, 2)."""
    rounds = kabsch.jacobi_rounds(n)
    assert len(rounds) == n + (n & 1) - 1
    pairs = [p for r in rounds for p in r]
    assert sorted(pairs) == [(p, q) for p in range(n)
                             for q in range(p + 1, n)]
    for r in rounds:
        cols = [c for p in r for c in p]
        assert len(set(cols)) == len(cols) and all(p < q for p, q in r)
        assert len(r) == n // 2
    if n == 3:
        assert pairs == [(0, 1), (0, 2), (1, 2)]


def hestenes_cyclic(a):
    """H11's one-sided Jacobi as it ran before the round-robin order: the
    pairs (p, q) one at a time in cyclic order (0, 1), (0, 2), ..., (n-2,
    n-1); otherwise ``kabsch._hestenes``."""
    B, m, n = a.shape
    eye = torch.eye(n, dtype=a.dtype).expand(B, n, n)
    cols = list(torch.cat([a, eye], dim=-2).unbind(-1))
    done = torch.zeros(B, dtype=torch.bool)
    sweeps = torch.zeros(B, dtype=torch.int32)
    for _ in range(kabsch.JACOBI_MAX_SWEEPS):
        rotated = torch.zeros_like(done)
        for p in range(n - 1):
            for q in range(p + 1, n):
                x, y = cols[p], cols[q]
                xa, ya = x[:, :m], y[:, :m]
                g_pp, g_qq, g_pq = kabsch._chain_sum(torch.stack(
                    [xa * xa, ya * ya, xa * ya], dim=1)).unbind(-1)
                rot = ~(g_pq.abs()
                        <= kabsch.JACOBI_TOL * torch.sqrt(g_pp * g_qq))
                x2, y2 = kabsch._rotate(x, y, g_pp, g_qq, g_pq)
                cols[p] = torch.where(rot[:, None], x2, x)
                cols[q] = torch.where(rot[:, None], y2, y)
                rotated = rotated | rot
        sweeps = sweeps + (~done).to(torch.int32)
        done = done | ~rotated
    M = torch.stack(cols, dim=-1)
    A, V = M[:, :m, :], M[:, m:, :]
    norm = torch.sqrt(kabsch._chain_sum((A * A).transpose(-1, -2)))
    S, order = torch.sort(norm, dim=-1, descending=True, stable=True)
    A = A.gather(-1, order[:, None, :].expand(B, m, n))
    V = V.gather(-1, order[:, None, :].expand(B, n, n))
    return S, V, kabsch._left_3x3(A, V, S).transpose(-1, -2), sweeps


@pytest.mark.parametrize("case", ["essential", "degenerate", "random"])
def test_3x3_bits_equal_the_cyclic_order(case):
    """On 3x3 matrices the round-robin order is the cyclic one: S, V, U and
    the sweeps bit for bit as before."""
    if case == "essential":
        a = svd_cases.essentials(3, 16)
    elif case == "degenerate":
        a = svd_cases.degenerate_3x3()
    else:
        a = np.random.default_rng(4).normal(size=(64, 3, 3))
        a[5, 1, 1] = np.nan
    a = torch.from_numpy(a)
    for got, want in zip(kabsch.jacobi_svd_plain(a), hestenes_cyclic(a)):
        assert tk.same_bits(got, want).all()


@pytest.mark.parametrize("shape", [(5, 9), (8, 9), (3, 3), (9, 9)])
def test_card_route_svd_shapes_and_values(shape):
    """``svd`` on the card's route keeps the caller's type and shapes: S
    min(m, n) values, Vh n x n, U only for 3x3; values as LAPACK's within
    the float32 input's rounding."""
    a = np.random.default_rng(5).normal(size=(4,) + shape).astype(np.float32)
    with kabsch.card_svd_route():
        U, S, Vh = kabsch.svd(torch.from_numpy(a))
    m, n = shape
    assert S.shape == (4, min(m, n)) and Vh.shape == (4, n, n)
    assert S.dtype == Vh.dtype == torch.float32
    assert (U is None) == (shape != (3, 3))
    Sj = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(S.numpy(), Sj, rtol=1e-6, atol=1e-6)
    if U is not None:
        assert np.allclose(np.linalg.det(U.numpy()), 1.0, atol=1e-6)


@pytest.mark.parametrize("f", [28, 61])
def test_card_route_refit_and_pose_match_jax(f):
    """The refit (H11 on the float64 Gram) and recoverPose (H11 on 3x3)
    on the card's route against JAX's on the corridor's inliers: E within
    1e-4 up to sign, the support mask equal, R and t within 1e-4."""
    with np.load(DATA) as z:
        x1, x2, inl = (z[f"f{f}_{k}"] for k in ("x1", "x2", "inliers"))
    args = [torch.from_numpy(x) for x in (x1, x2, inl)]
    with kabsch.card_svd_route():
        E = ransac._masked_eight_point(*args)
        R, t, good = ransac.recover_pose(E, *args)
    Ej = np.asarray(jax.jit(jransac._masked_eight_point)(x1, x2, inl))
    d = min(np.abs(E.numpy() - Ej).max(), np.abs(E.numpy() + Ej).max())
    assert d < 1e-4, d
    Rj, tj, gj = (np.asarray(v) for v in jax.jit(jransac.recover_pose)(
        E.numpy(), x1, x2, inl))
    np.testing.assert_array_equal(good.numpy(), gj)
    np.testing.assert_allclose(R.numpy(), Rj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.numpy(), tj, rtol=0, atol=1e-4)


def test_mono_step_on_the_card_route_traces_without_a_host_read():
    """The mono step as the card runs it (every SVD H11's operator), traced
    with fake tensors: a host read of a tensor's value (a data-dependent
    guard) would stop the trace; the operator is a node of the graph."""
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(0, 256, (96, 128)).astype(np.uint8))
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    odo = mono.MonoOdometer(K, nfeatures=100, ransac_iters=64,
                            device="cpu")
    u = torch.from_numpy(rng.random((mono.ransac_samples(64), 5))
                         .astype(np.float32))
    scale = torch.tensor(0.3)

    def step(state, img, scale, u):
        return odo._step(state, img, scale, u)

    with kabsch.card_svd_route():
        step(odo.state, img, scale, u)
        graph = make_fx(step, tracing_mode="fake",
                        _allow_non_fake_inputs=True)(odo.state, img, scale,
                                                     u)
    targets = [str(n.target) for n in graph.graph.nodes]
    assert sum("openvo_torch.jacobi_svd" in t for t in targets) == 9
    assert not any("linalg_svd" in t for t in targets)
