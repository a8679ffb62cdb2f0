"""The PyTorch port's openVO API helpers against the JAX package's:
``rot2RPY`` (both Euler branches and gimbal lock; the port computes in
float64, JAX in float32 with x64 off, so within 1e-6 rad) and
``drawPoseOnImage`` (pixel for pixel, on gray and BGR frames). Cases follow
tests/test_se3.py and tests/test_io_utils.py."""

import numpy as np
import pytest

import openvo_tpu
import openvo_tpu_torch


def rotation(rvec):
    """Rodrigues' formula in float64."""
    th = np.linalg.norm(rvec)
    if th == 0:
        return np.eye(3)
    k = rvec / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def make_T(R, t=(0.0, 0.0, 0.0)):
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def assert_rpy_match(T):
    got = openvo_tpu_torch.rot2RPY(T)
    want = openvo_tpu.rot2RPY(T)
    for g, w in zip(got, want):
        assert g.shape == (2, 1) and g.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    return got


@pytest.mark.parametrize("seed", range(8))
def test_rot2rpy_matches_jax_and_reconstructs(seed):
    R = rotation(np.random.default_rng(seed).normal(size=3))
    roll, pitch, yaw = assert_rpy_match(make_T(R))
    for b in (0, 1):
        Rx = rotation(np.array([roll[b].item(), 0, 0]))
        Ry = rotation(np.array([0, pitch[b].item(), 0]))
        Rz = rotation(np.array([0, 0, yaw[b].item()]))
        np.testing.assert_allclose(Rz @ Ry @ Rx, R, atol=1e-12)


@pytest.mark.parametrize("pitch", [np.pi / 2, -np.pi / 2])
def test_rot2rpy_gimbal_lock(pitch):
    """cos_theta < 1e-4: yaw = 0, pitch = -R20 pi/2 on both branches."""
    R = rotation(np.array([0, pitch, 0])) @ rotation(np.array([0.3, 0, 0]))
    roll, p, yaw = assert_rpy_match(make_T(R))
    np.testing.assert_array_equal(yaw, 0.0)
    np.testing.assert_allclose(p.ravel(), [pitch, pitch], atol=1e-12)
    assert roll[0] == roll[1]


def test_rot2rpy_identity_shapes():
    """(2, 1) arrays; the first branch of the identity is all zero."""
    for v in assert_rpy_match(np.eye(4)):
        assert v[0, 0] == 0.0


@pytest.mark.parametrize("rvec,t", [
    ((0.0, 0.0, 0.0), (1.0, 2.0, 3.0)),
    ((0.1, 1.2, -0.4), (0.0, 0.0, 0.0)),     # the branches differ
    ((-0.3, 0.2, 2.5), (-12.34, 0.05, 250.0)),
])
@pytest.mark.parametrize("color", [True, False])
def test_draw_pose_on_image_matches_jax(rvec, t, color):
    T = make_T(rotation(np.array(rvec)), t)
    shape = (240, 320, 3) if color else (240, 320)
    img = np.random.default_rng(0).integers(0, 200, shape).astype(np.uint8)
    want = openvo_tpu.drawPoseOnImage(T, img.copy())
    got_img = img.copy()
    got = openvo_tpu_torch.drawPoseOnImage(T, got_img)
    assert got is got_img   # drawn in place, like the reference
    np.testing.assert_array_equal(got, want)
    assert (got != img).sum() > 200


def test_api_exports_match_the_reference_package():
    assert set(openvo_tpu_torch.__all__) == set(openvo_tpu.__all__)
