"""The PyTorch port's MonoOdometer against the JAX package's, on the CPU,
over the 6-frame 320x240 corridor of tests/test_mono.py:189-203 with JAX's
draws replayed: each frame's uniforms are taken from JAX's key chain and
passed to the port's update, so both draw the same RANSAC samples.

Keypoints, descriptors and matches are bit-equal (tests/test_torch_orb.py);
the five-point candidates then come from the port's own SVD basis, so the
poses agree within the tolerances stated below, not bit for bit, and the
accept and skip codes must be equal at every frame."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvo_tpu.io.synthetic import render_stereo_sequence
from openvo_tpu.models import mono_odometer as jmono
from openvo_tpu_torch.models import mono_odometer as mono
from openvo_tpu_torch.pose import kabsch

N = 6
CARRY_AT = 3
STEP = 0.3
# Each frame's motion (the relative pose from the previous accepted frame)
# against JAX's: the rotation between the two (rad) and the angle between
# their translation directions (rad). The candidates come from another null
# -space basis, so another near-tie E can win the MSAC vote: on frame 1 the
# top-8 lists share 4 candidates and the refits differ by 0.05 in E
# (measured: rotations 2.7e-3 rad and directions 0.05 rad apart). JAX's own
# direction error against the truth is 1-3 degrees (ransac.py:170); the
# bar is about twice that.
ROT_TOL = 5e-3
DIR_TOL = 0.1


def frame(seq, i):
    return np.clip(seq["left"][i], 0, 255).astype(np.uint8)


def jax_uniforms(state, iters):
    """The uniforms jax.random.choice draws in JAX's step for ``state``."""
    _, sub = jax.random.split(state.key)
    return np.array(jax.random.uniform(sub, (iters, 5), dtype=jnp.float32))


@pytest.fixture(scope="module")
def seq():
    return render_stereo_sequence(n_frames=N, img_size=(320, 240), f=280.0,
                                  baseline=0.5, seed=0, step=STEP,
                                  yaw_rate=0.004)


@pytest.fixture(scope="module")
def jax_run(seq):
    """JAX's odometer over the frames: per frame its uniforms, accept,
    stats and pose; its state's leaves before frame CARRY_AT."""
    odo = jmono.MonoOdometer(seq["K"], nfeatures=300)
    iters = mono.ransac_samples(256)
    out, leaves = [], None
    for i in range(N):
        if i == CARRY_AT:
            leaves = [np.array(x) for x in
                      jax.tree_util.tree_flatten(odo._state)[0]]
        u = jax_uniforms(odo._state, iters)
        ok = odo.update(frame(seq, i), trans_scale=STEP)
        out.append({"u": u, "ok": ok, "cause": odo.skip_cause,
                    "stats": {k: int(v) for k, v in odo.last_stats.items()},
                    "pose": odo.current_pose()})
    return out, leaves


def run_port(odo, seq, want, frames):
    got = []
    for i in frames:
        ok = odo.update(frame(seq, i), trans_scale=STEP,
                        u=torch.from_numpy(want[i]["u"]))
        got.append({"ok": ok, "cause": odo.skip_cause,
                    "stats": {k: int(v) for k, v in odo.last_stats.items()},
                    "pose": odo.current_pose()})
    return got


@pytest.fixture(scope="module")
def port_run(seq, jax_run):
    want, _ = jax_run
    odo = mono.MonoOdometer(seq["K"], nfeatures=300, device="cpu")
    return run_port(odo, seq, want, range(N))


def motion_gap(a0, a1, b0, b1):
    """(rotation in rad, angle between translation directions in rad) of
    the motion a0 -> a1 against b0 -> b1 (4x4 camera-in-world poses)."""
    ma, mb = np.linalg.inv(a0) @ a1, np.linalg.inv(b0) @ b1
    c = np.clip((np.trace(ma[:3, :3].T @ mb[:3, :3]) - 1) / 2, -1.0, 1.0)
    ta, tb = ma[:3, 3], mb[:3, 3]
    cd = ta @ tb / max(np.linalg.norm(ta) * np.linalg.norm(tb), 1e-12)
    return float(np.arccos(c)), float(np.arccos(np.clip(cd, -1.0, 1.0)))


def assert_motions_match(got, want, start=None):
    prev_g = prev_w = np.eye(4) if start is None else start
    for i, (g, w) in enumerate(zip(got, want)):
        if i or start is not None:
            rot, ang = motion_gap(prev_g, g["pose"], prev_w, w["pose"])
            assert rot < ROT_TOL and ang < DIR_TOL, (i, rot, ang)
        prev_g, prev_w = g["pose"], w["pose"]


def test_accept_and_skip_codes_match_jax(jax_run, port_run):
    want, _ = jax_run
    for i, (g, w) in enumerate(zip(port_run, want)):
        assert g["ok"] == w["ok"], f"frame {i}"
        assert g["cause"] == w["cause"], f"frame {i}"
        assert g["stats"]["skip_code"] == w["stats"]["skip_code"]
        # ORB and the matcher are bit-equal
        for k in ("n_kps", "n_matches"):
            assert g["stats"][k] == w["stats"][k], (i, k)
        # inliers and support move with the chosen E (frame 1: support
        # 116 against 108): within 15%
        for k in ("n_inliers", "n_support"):
            assert abs(g["stats"][k] - w["stats"][k]) <= max(
                2, 0.15 * w["stats"][k]), (i, k, g["stats"], w["stats"])
    assert all(w["ok"] for w in want)


def test_poses_match_jax(seq, jax_run, port_run):
    want, _ = jax_run
    assert_motions_match(port_run, want)
    # the JAX test's bars against the ground truth (tests/test_mono.py:198)
    pose, gt = port_run[-1]["pose"], seq["T_wc"][N - 1]
    assert np.linalg.norm(pose[:3, 3] - gt[:3, 3]) < 0.45
    np.testing.assert_allclose(pose[:3, :3], gt[:3, :3], atol=0.05)


def test_card_svd_route_matches_jax(seq, jax_run):
    """The same run with every SVD as the card runs it (``pose/kabsch.
    card_svd_route``: the Jacobi SVD H11's plain version in float64, the
    refit on the Gram): JAX's accept and skip codes at every frame, and
    each frame's motion within the tolerances above."""
    want, _ = jax_run
    odo = mono.MonoOdometer(seq["K"], nfeatures=300, device="cpu")
    with kabsch.card_svd_route():
        got = run_port(odo, seq, want, range(N))
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g["ok"], g["cause"]) == (w["ok"], w["cause"]), i
        assert g["stats"]["skip_code"] == w["stats"]["skip_code"], i
    assert_motions_match(got, want)


def test_state_from_jax_leaves_continues_jax(seq, jax_run):
    """JAX's state before frame CARRY_AT, carried into the port, then the
    remaining frames with JAX's draws: the same codes, and each frame's
    motion within the tolerances above."""
    want, leaves = jax_run
    odo = mono.MonoOdometer(seq["K"], nfeatures=300, device="cpu")
    odo.state = mono.state_from_jax_leaves(leaves, "cpu")
    assert odo.skipped_frames == 0
    got = run_port(odo, seq, want, range(CARRY_AT, N))
    for g, w in zip(got, want[CARRY_AT:]):
        assert (g["ok"], g["cause"]) == (w["ok"], w["cause"])
    assert_motions_match(got, want[CARRY_AT:],
                         start=want[CARRY_AT - 1]["pose"])


def test_blank_frame_skip_surface(seq):
    """tests/test_mono.py:175-187 on both: the first frame accepted, a
    blank one refused with the same cause; the port draws from its own
    generator once a frame, the first frame included."""
    img0 = frame(seq, 0)
    blank = np.full_like(img0, 127)
    jodo = jmono.MonoOdometer(seq["K"], nfeatures=300)
    odo = mono.MonoOdometer(seq["K"], nfeatures=300, device="cpu")
    assert odo.update(img0) and jodo.update(img0)
    assert odo.skip_cause == jodo.skip_cause == ""
    assert odo.update(blank) is False and jodo.update(blank) is False
    assert odo.skip_cause == jodo.skip_cause
    assert odo.skip_cause in ("keypoints", "matches", "inliers", "support")
    assert odo.skipped_frames == jodo.skipped_frames == 1
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        torch.rand((mono.ransac_samples(256), 5), generator=gen)
    assert torch.equal(odo.state.generator.get_state(), gen.get_state())


def test_own_sampler_tracks_the_corridor(seq):
    """The port's own draws, as users run it: every frame tracked and the
    JAX test's bars against the ground truth (tests/test_mono.py:189-203)."""
    odo = mono.MonoOdometer(seq["K"], nfeatures=300, device="cpu")
    for i in range(N):
        assert odo.update(frame(seq, i), trans_scale=STEP), (
            i, odo.last_stats)
    pose, gt = odo.current_pose(), seq["T_wc"][N - 1]
    assert np.linalg.norm(pose[:3, 3] - gt[:3, 3]) < 0.45
    np.testing.assert_allclose(pose[:3, :3], gt[:3, :3], atol=0.05)


@pytest.mark.parametrize("entry", ["odometer", "init_state", "leaves"])
def test_default_device_is_the_card(seq, entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "odometer":
            mono.MonoOdometer(seq["K"])
        elif entry == "init_state":
            mono.init_state(512)
        else:
            mono.state_from_jax_leaves([np.zeros(1)] * 7)


def test_state_from_jax_leaves_checks_the_count():
    with pytest.raises(ValueError, match="7 leaves"):
        mono.state_from_jax_leaves([np.zeros(1)] * 6, "cpu")
