"""The port's mono odometer stage by stage at frames 28 and 61 of the bench
corridor (1242x376), where it parts from the JAX package's run with JAX's
draws replayed (chip_smoke.py's `mono` path, tools/compare_mono_runs.py).

tests/data/mono_stages.npz holds JAX's inputs and outputs of every stage of
those two updates (``JAX_PLATFORMS=cpu python3 tools/jax_mono_stages.py``
writes it, from one jitted program that gives the update's own stats).
Each test feeds the port one stage's JAX inputs:

- the ratio-test matches and the sampler equal JAX's;
- the five-point candidates are the first stage that parts: the port's
  null-space basis (torch's SVD) is another basis of the same 4-D null
  space than LAPACK's under JAX, and the float32 solver's roots move with
  the basis, so the candidate sets differ (JAX's winner at frame 28 has no
  counterpart in the port's set);
- fed JAX's candidates, the port's selection (MSAC, top 8, cheirality
  vote, guarded refits) and recoverPose give JAX's E, inliers, R and t.

The two frames are not near-planar (a homography leaves 78% and 85% of
the inliers more than 1 px off) but of low parallax (median flow 4.2 and
6.0 px under forward motion), where many E's fit about equally: the
port's E and JAX's score within a few percent of each other.
``test_own_candidates_within_bound`` holds the port to that bound and
shows both E's and their scores.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from openvo_tpu.ops import hamming as jhamming
from openvo_tpu_torch.ops import hamming
from openvo_tpu_torch.pose import fivepoint, ransac

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "mono_stages.npz")
FRAMES = [28, 61]
# The port's own E against JAX's, on the same points (measured: MSAC
# 1.2699e-4 against 1.2070e-4 at frame 28 (+5.2%), 1.2120e-4 against
# 1.2240e-4 at 61 (-1.0%); inliers 298/297 and 303/309; E 0.071 and 0.285
# apart up to sign).
MSAC_RATIO = 1.06
INLIER_RATIO = 0.03


@pytest.fixture(scope="module")
def stages():
    with np.load(DATA) as z:
        return {k: z[k] for k in z.files}


def frame(stages, f):
    return {k[len(f"f{f}_"):]: v for k, v in stages.items()
            if k.startswith(f"f{f}_")}


def t(a):
    return torch.from_numpy(np.array(a))


def up_to_sign(a, b):
    return min(np.abs(a - b).max(), np.abs(a + b).max())


def msac(E, g):
    thr = float(g["thresh"])
    err = ransac.sampson_error(t(E), t(g["x1"]), t(g["x2"]))
    return float(torch.where(t(g["mok"]), err.clamp_max(thr), 0.0).sum())


def test_data_is_the_updates_own(stages):
    """The recomputed stages gave the update's own stats at both frames."""
    assert [int(f) for f in stages["frames"]] == FRAMES
    for f in FRAMES:
        assert bool(stages[f"f{f}_same_as_update"])


@pytest.mark.parametrize("f", FRAMES)
def test_matches_and_samples_equal_jax(stages, f):
    """Fed JAX's descriptors (the state's and the frame's), the ratio test
    gives JAX's matches; fed JAX's uniforms and match mask, the sampler
    gives JAX's 64 x 5 indices."""
    g = frame(stages, f)
    args = (g["cur_desc"], g["desc"], 0.8, g["cur_valid"], g["kp_valid"])
    idx, ok = hamming.ratio_test_match(*map(t, args))
    np.testing.assert_array_equal(idx.numpy(), g["train_idx"])
    np.testing.assert_array_equal(ok.numpy(), g["mok"])
    jidx, jok = jhamming.ratio_test_match(*map(jnp.asarray, args))
    np.testing.assert_array_equal(np.asarray(jok), g["mok"])
    np.testing.assert_array_equal(
        ransac.sample_indices(t(g["u"]), t(g["mok"])).numpy(), g["idx"])


@pytest.mark.parametrize("f", FRAMES)
def test_candidates_are_the_first_stage_that_parts(stages, f):
    """The port's five-point candidates on JAX's samples differ from
    JAX's: at frame 28 JAX's winning candidate has no counterpart within
    1e-3 in the port's set, at 61 JAX's third-best; the best MSAC of the
    two sets still lies within MSAC_RATIO."""
    g = frame(stages, f)
    x1, x2 = t(g["x1"]), t(g["x2"])
    Es, valid = fivepoint.five_point_candidates(x1[t(g["idx"])],
                                                x2[t(g["idx"])])
    mine = Es.numpy()[valid.numpy()]
    jE = g["Es"].reshape(-1, 3, 3)
    missing = g["top_i"][0 if f == 28 else 2]
    near = min(up_to_sign(m, jE[missing]) for m in mine)
    assert near > 1e-3, near
    best_mine = min(msac(E, g) for E in mine)
    assert best_mine <= MSAC_RATIO * float(g["top_m"][0])
    assert float(g["top_m"][0]) <= MSAC_RATIO * best_mine


@pytest.mark.parametrize("f", FRAMES)
def test_selection_and_pose_fed_jax_candidates_equal_jax(stages, f):
    """Every stage after the candidates: fed JAX's candidates, the port
    chooses JAX's E bit for bit, with its inliers, and recoverPose gives
    JAX's support, R and t."""
    g = frame(stages, f)
    x1, x2, mok = t(g["x1"]), t(g["x2"]), t(g["mok"])
    E, inl, n = ransac.select_essential(t(g["Es"]), t(g["valid"]), x1, x2,
                                        mok, float(g["thresh"]))
    np.testing.assert_array_equal(E.numpy(), g["E"])
    np.testing.assert_array_equal(inl.numpy(), g["inliers"])
    assert int(n) == int(g["n_inl"])
    R, tv, sup = ransac.recover_pose(E, x1, x2, inl)
    np.testing.assert_array_equal(sup.numpy(), g["support_mask"])
    np.testing.assert_allclose(R.numpy(), g["R"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), g["t"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("f", FRAMES)
def test_own_candidates_within_bound(stages, f):
    """The port's whole RANSAC on JAX's matches and uniforms: another E
    than JAX's (up to sign more than 0.05 apart), that fits the same
    points about as well: its MSAC within MSAC_RATIO of JAX's E's and its
    inlier count within INLIER_RATIO."""
    g = frame(stages, f)
    x1, x2, mok = t(g["x1"]), t(g["x2"]), t(g["mok"])
    E, inl, n = ransac.ransac_essential_5pt(x1, x2, mok, t(g["u"]),
                                            iters=64,
                                            inlier_threshold=float(
                                                g["thresh"]))
    mine, theirs = msac(E.numpy(), g), msac(g["E"], g)
    print(f"frame {f}: port E {E.numpy().tolist()} MSAC {mine} inliers "
          f"{int(n)}; JAX E {g['E'].tolist()} MSAC {theirs} inliers "
          f"{int(g['n_inl'])}")
    assert up_to_sign(E.numpy(), g["E"]) > 0.05
    assert mine <= MSAC_RATIO * theirs and theirs <= MSAC_RATIO * mine
    assert abs(int(n) - int(g["n_inl"])) <= INLIER_RATIO * int(g["n_inl"])
