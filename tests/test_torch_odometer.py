"""The PyTorch port's StereoOdometer against the JAX package's, frame by
frame, on the 10-frame 320x240 corridor of tests/test_odometer.py: the same
ok and skip_cause on every frame and poses within atol 1e-4 (Kabsch, the
SVD and sums run in another order; disparity, keypoints and descriptors
are bit-equal, see the other test_torch_* files)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvo_tpu
import openvo_tpu_torch
from openvo_tpu.config import OdometerConfig as JaxOdometerConfig
from openvo_tpu.config import ORBParams as JaxORBParams
from openvo_tpu.io.synthetic import render_stereo_sequence
from openvo_tpu.models.stereo_odometer import (
    make_point_cloud_transform as jax_pct)
from openvo_tpu_torch.config import OdometerConfig, ORBParams
from openvo_tpu_torch.models.stereo_odometer import (
    make_point_cloud_transform, state_from_jax_leaves)

IMG_SIZE = (320, 240)
SGBM = {
    "minDisparity": 0, "numDisparities": 96, "blockSize": 5,
    "P1": 200, "P2": 800, "disp12MaxDiff": 1, "preFilterCap": 63,
    "uniquenessRatio": 10, "speckleWindowSize": 0, "speckleRange": 0,
}
N = 10
CARRY_AT = 5
POSE_ATOL = 1e-4


def frame(seq, i):
    return (np.clip(seq["left"][i], 0, 255).astype(np.uint8),
            np.clip(seq["right"][i], 0, 255).astype(np.uint8))


def cameras(seq):
    args = (seq["K"], seq["dist"], seq["K"], seq["dist"],
            {"R": seq["R"], "T": seq["T"]}, SGBM, IMG_SIZE)
    return (openvo_tpu.StereoCamera(*args),
            openvo_tpu_torch.StereoCamera(*args, device="cpu"))


@pytest.fixture(scope="module")
def seq():
    return render_stereo_sequence(n_frames=N, img_size=IMG_SIZE, f=280.0,
                                  baseline=0.5, seed=0, step=0.3,
                                  yaw_rate=0.006)


@pytest.fixture(scope="module")
def jax_run(seq):
    """The JAX odometer over the sequence: per-frame (ok, cause, pose),
    and its state's leaves after frame CARRY_AT - 1."""
    cam, _ = cameras(seq)
    odo = openvo_tpu.StereoOdometer(cam)
    out, leaves = [], None
    for i in range(N):
        if i == CARRY_AT:
            leaves = [np.asarray(x) for x in
                      jax.tree_util.tree_flatten(odo.state)[0]]
        ok = odo.update(*frame(seq, i))
        out.append((ok, odo.skip_cause, odo.current_pose()))
    return out, leaves


def assert_frame_matches(i, got, want):
    assert got[0] == want[0], f"frame {i}: ok {got[0]} vs {want[0]}"
    assert got[1] == want[1], f"frame {i}: cause {got[1]!r} vs {want[1]!r}"
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=POSE_ATOL,
                               err_msg=f"frame {i}")


def test_ten_frames_match_jax(seq, jax_run):
    want, _ = jax_run
    _, cam = cameras(seq)
    odo = openvo_tpu_torch.StereoOdometer(cam)
    for i in range(N):
        ok = odo.update(*frame(seq, i))
        assert_frame_matches(i, (ok, odo.skip_cause, odo.current_pose()),
                             want[i])
    assert sum(w[0] for w in want) >= 9


def test_state_carried_from_jax(seq, jax_run):
    """Frames 0-4 in JAX, the state carried across, frames 5-9 here: the
    same as JAX's 10-frame run."""
    want, leaves = jax_run
    _, cam = cameras(seq)
    odo = openvo_tpu_torch.StereoOdometer(cam)
    odo.state = state_from_jax_leaves(leaves, device="cpu")
    for i in range(CARRY_AT, N):
        ok = odo.update(*frame(seq, i))
        assert_frame_matches(i, (ok, odo.skip_cause, odo.current_pose()),
                             want[i])


def test_save_load_state_round_trip(seq, tmp_path):
    _, cam = cameras(seq)
    odo = openvo_tpu_torch.StereoOdometer(cam)
    for i in range(2):
        assert odo.update(*frame(seq, i))
    path = odo.save_state(tmp_path / "state.npz")
    other = openvo_tpu_torch.StereoOdometer(cam)
    other.load_state(path)
    np.testing.assert_array_equal(other.current_pose(), odo.current_pose())
    np.testing.assert_array_equal(other.current_desc, odo.current_desc)
    assert other.skipped_frames == odo.skipped_frames


def test_attribute_surface_and_blank_frames(seq):
    _, cam = cameras(seq)
    odo = openvo_tpu_torch.StereoOdometer(cam)
    Hc, Wc = cam.cropped_shape
    for i in range(2):
        assert odo.update(*frame(seq, i))
    assert odo.current_img.shape == odo.prev_img.shape == (Hc, Wc)
    assert odo.current_3d.shape == odo.prev_3d.shape == (Hc, Wc, 3)
    assert odo.current_disparity.shape == (Hc, Wc)
    assert len(odo.current_kps) >= 10 and odo.current_desc.shape[1] == 32
    assert not np.array_equal(odo.current_img, odo.prev_img)
    blank = np.full((IMG_SIZE[1], IMG_SIZE[0]), 100, np.uint8)
    assert odo.update(blank, blank) is False
    assert odo.skip_cause == "keypoints" and odo.skipped_frames == 1


def crafted(kind):
    rng = np.random.default_rng(1)
    a = rng.uniform(-3, 3, (32, 3)).astype(np.float32)
    if kind == "bigrot":   # both gates fire: bigrot wins
        ang = 1.5
        R = np.array([[np.cos(ang), -np.sin(ang), 0],
                      [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
        return a, a @ R.T + np.float32([2.0, 0, 0])
    b = a + np.float32([1.5 if kind == "bigdist" else 0.05, 0, 0])
    if kind == "nan":
        a[4] = np.nan
    return a, b


@pytest.mark.parametrize("kind,skipped,min_matches,n_valid", [
    ("bigdist", 0, 10, 32), ("bigdist", 1, 10, 32), ("bigrot", 0, 10, 32),
    ("nan", 0, 10, 32), ("ok", 0, 10, 32), ("ok", 0, 10, 8),
    ("ok", 0, 5, 8),
])
def test_point_cloud_transform_gates_match_jax(kind, skipped, min_matches,
                                               n_valid):
    a, b = crafted(kind)
    mask = np.arange(32) < n_valid
    Tj, okj, cj = jax.jit(jax_pct(JaxOdometerConfig(min_matches=min_matches)))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask),
        jnp.asarray(skipped, jnp.int32), jnp.asarray(0, jnp.int32))
    Tt, okt, ct = make_point_cloud_transform(
        OdometerConfig(min_matches=min_matches))(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(mask),
        torch.tensor(skipped, dtype=torch.int32),
        torch.tensor(0, dtype=torch.int32))
    assert bool(okt) == bool(okj)
    assert int(ct) == int(cj)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=1e-5,
                               equal_nan=True)


FILTERS = dict(rigidity_threshold=0.05, outlier_threshold=0.01)


def filter_cases(kind):
    """Point clouds for the filters' gates (tests/test_odometer.py:214-235):
    ``rigid_few`` keeps 8 of 16 points in the clique, ``outlier_spread``
    spreads the residuals of 12 points, ``planted`` has 6 non-rigid points
    among 32."""
    rng = np.random.default_rng(2)
    if kind == "rigid_few":
        a = rng.uniform(-3, 3, size=(16, 3)).astype(np.float32)
        b = a + np.float32([0.05, 0, 0])
        b[8:] += rng.uniform(0.5, 1.0, size=(8, 3)).astype(np.float32)
    elif kind == "outlier_spread":
        rng0 = np.random.default_rng(0)
        a = rng0.uniform(-3, 3, (12, 3)).astype(np.float32)
        b = a + np.float32([0.05, 0, 0])
        b[6:] += np.linspace(1, 3, 6)[:, None].astype(np.float32)
    elif kind == "planted":
        a = rng.uniform(-3, 3, size=(32, 3)).astype(np.float32)
        b = a + np.float32([0.05, 0.01, 0])
        b[:6] += rng.normal(scale=0.3, size=(6, 3)).astype(np.float32)
    else:
        a, b = crafted(kind)
    return a, b


@pytest.mark.parametrize("kind", ["rigid_few", "outlier_spread", "planted",
                                  "bigdist", "nan", "ok"])
@pytest.mark.parametrize("cfg", [
    dict(rigidity_threshold=0.01, min_matches=5),
    dict(outlier_threshold=0.01),
    dict(FILTERS)])
def test_point_cloud_transform_filters_match_jax(kind, cfg):
    """With each filter on and with both: the same skip code and ok as JAX,
    T within atol 1e-5 (the clique and the inlier mask are equal)."""
    a, b = filter_cases(kind)
    mask = np.ones(len(a), bool)
    mask[-1] = kind != "planted"
    Tj, okj, cj = jax.jit(jax_pct(JaxOdometerConfig(**cfg)))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask),
        jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))
    Tt, okt, ct = make_point_cloud_transform(OdometerConfig(**cfg))(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(mask),
        torch.tensor(0, dtype=torch.int32),
        torch.tensor(0, dtype=torch.int32))
    assert int(ct) == int(cj)
    assert bool(okt) == bool(okj)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=1e-5,
                               equal_nan=True)


@pytest.fixture(scope="module")
def filters_runs(seq):
    """JAX's and the port's odometers over the sequence with both filters
    on: per-frame (ok, cause, pose) of each, and the two odometers."""
    cam_j, cam_t = cameras(seq)
    odos = (openvo_tpu.StereoOdometer(cam_j, **FILTERS),
            openvo_tpu_torch.StereoOdometer(cam_t, **FILTERS))
    runs = ([], [])
    for i in range(N):
        for odo, run in zip(odos, runs):
            ok = odo.update(*frame(seq, i))
            run.append((ok, odo.skip_cause, odo.current_pose()))
    return runs, odos


def test_ten_frames_with_filters_match_jax(filters_runs):
    """Frame by frame as JAX. At 320x240 the clique at 0.05 m keeps fewer
    than 10 points on some frames, so JAX skips those as "rigidity" (5 of
    10 frames tracked): both outcomes of the filters are held to it."""
    (want, got), _ = filters_runs
    for i in range(N):
        assert_frame_matches(i, got[i], want[i])
    assert sum(w[0] for w in want) >= 5
    assert "rigidity" in [w[1] for w in want]


def test_cv2_ranking_odometer_matches_jax(seq):
    """ORB with cv2.ORB's two-stage retention (``cv2_ranking=True``) in
    both odometers over the first 4 frames: the same ok and skip_cause,
    poses within POSE_ATOL."""
    cam_j, cam_t = cameras(seq)
    odo_j = openvo_tpu.StereoOdometer(cam_j, config=JaxOdometerConfig(
        orb=JaxORBParams(cv2_ranking=True)))
    odo_t = openvo_tpu_torch.StereoOdometer(cam_t, config=OdometerConfig(
        orb=ORBParams(cv2_ranking=True)))
    for i in range(4):
        want = (odo_j.update(*frame(seq, i)), odo_j.skip_cause,
                odo_j.current_pose())
        got = (odo_t.update(*frame(seq, i)), odo_t.skip_cause,
               odo_t.current_pose())
        assert_frame_matches(i, got, want)
    assert want[0]


def test_filter_methods_match_jax(filters_runs):
    """The reference methods rigid_body_filter and valid_distance_change,
    numpy in and out, on the odometers' last two frames."""
    _, (odo_j, odo_t) = filters_runs
    a, b = filter_cases("planted")
    got = odo_t.rigid_body_filter(a, b)
    np.testing.assert_array_equal(got, odo_j.rigid_body_filter(a, b))
    assert got.dtype == np.int32 and got[:6].sum() == 0
    np.testing.assert_array_equal(odo_t.prev_kps, odo_j.prev_kps)
    np.testing.assert_array_equal(odo_t.current_kps, odo_j.current_kps)
    pairs = [(i, j) for i in range(0, len(odo_j.prev_kps), 37)
             for j in range(0, len(odo_j.current_kps), 41)]
    assert len(pairs) > 50
    for i, j in pairs:
        assert (odo_t.valid_distance_change(i, j)
                == odo_j.valid_distance_change(i, j))


def test_reference_helper_methods_match_jax(seq):
    cam_j, cam_t = cameras(seq)
    odo_j = openvo_tpu.StereoOdometer(cam_j)
    odo_t = openvo_tpu_torch.StereoOdometer(cam_t)
    disp = np.array([[3.0, 4.0], [100.0, 101.0]])
    np.testing.assert_array_equal(odo_t.feature_mask(disp),
                                  odo_j.feature_mask(disp))
    img = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    np.testing.assert_allclose(odo_t.bilinear_interpolate_pixels(img, 0.5, 0.5),
                               odo_j.bilinear_interpolate_pixels(img, 0.5, 0.5))
    a, b = crafted("ok")
    np.testing.assert_allclose(odo_t.point_cloud_transform(a, b),
                               odo_j.point_cloud_transform(a, b), atol=1e-5)
    assert odo_t.point_cloud_transform(a, a + np.float32([5, 0, 0])) is None
    assert odo_t.skip_cause == "bigdist"


def test_camera_from_npz_matches_constructor(seq, tmp_path):
    path = tmp_path / "calib.npz"
    np.savez(path, K_left=seq["K"], dist_left=seq["dist"], K_right=seq["K"],
             dist_right=seq["dist"], R=seq["R"], T=seq["T"],
             **{f"sgbm_{k}": v for k, v in SGBM.items()})
    cam = openvo_tpu_torch.StereoCamera.from_npz(path, IMG_SIZE, device="cpu")
    _, ref = cameras(seq)
    assert cam.sgbm == ref.sgbm and cam.cropped_shape == ref.cropped_shape
    for a, b in zip(cam.map_left + cam.map_right, ref.map_left + ref.map_right):
        assert torch.equal(a, b)


@pytest.mark.parametrize("entry", ["camera", "from_npz", "init_state",
                                   "state_from_jax_leaves", "tiled_sgbm"])
def test_default_device_is_the_card(seq, tmp_path, entry):
    """The entry points default to the card: without a card, leaving out
    ``device`` raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from openvo_tpu_torch.models import stereo_odometer
    from openvo_tpu_torch.parallel.tiling import make_tiled_sgbm_fn

    args = (seq["K"], seq["dist"], seq["K"], seq["dist"],
            {"R": seq["R"], "T": seq["T"]}, SGBM, IMG_SIZE)
    path = tmp_path / "calib.npz"
    np.savez(path, K_left=seq["K"], dist_left=seq["dist"], K_right=seq["K"],
             dist_right=seq["dist"], R=seq["R"], T=seq["T"],
             **{f"sgbm_{k}": v for k, v in SGBM.items()})
    leaves = stereo_odometer.state_leaves(
        stereo_odometer.init_state((4, 6), 8, device="cpu"))
    call = {
        "camera": lambda: openvo_tpu_torch.StereoCamera(*args),
        "from_npz": lambda: openvo_tpu_torch.StereoCamera.from_npz(path,
                                                                   IMG_SIZE),
        "init_state": lambda: stereo_odometer.init_state((4, 6), 8),
        "state_from_jax_leaves": lambda: stereo_odometer.state_from_jax_leaves(
            [x.numpy() for x in leaves]),
        "tiled_sgbm": lambda: make_tiled_sgbm_fn(
            openvo_tpu_torch.config.SGBMParams()),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
