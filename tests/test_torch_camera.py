"""The port's StereoCamera against the JAX package's on the CPU: the eager
rectification (``undistort_rectify_left``/``_right``) of a camera with a
distortion vector, on uint8 and float32 frames."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import openvo_tpu
import openvo_tpu_torch
from openvo_tpu.io.synthetic import render_stereo_sequence

IMG_SIZE = (160, 120)


def camera_args():
    """A rig with barrel distortion, so that the rectify maps are
    fractional everywhere."""
    seq = render_stereo_sequence(n_frames=1, img_size=IMG_SIZE, f=140.0,
                                 baseline=0.5, seed=0)
    dist = np.array([-0.12, 0.03, 0.001, -0.001, 0.0])
    sgbm = {"minDisparity": 0, "numDisparities": 32, "blockSize": 5,
            "P1": 200, "P2": 800, "disp12MaxDiff": 1, "preFilterCap": 63,
            "uniquenessRatio": 10, "speckleWindowSize": 0, "speckleRange": 0}
    return seq, (seq["K"], dist, seq["K"], dist,
                 {"R": seq["R"], "T": seq["T"]}, sgbm, IMG_SIZE)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_undistort_rectify_matches_jax(side, dtype):
    """The eager rectification equals JAX's bit for bit. JAX runs it op by
    op, each product and sum rounded on its own (no multiply-add fused, no
    weight folded), so the port does the same there, while its jitted
    ``compute_3d`` path keeps XLA's fused form (``ops/remap.make_remap``).
    uint8 frames come back rounded to uint8; float32 frames (here with a
    fractional part everywhere) stay float32, where a fused multiply-add
    would differ in the last bits."""
    seq, args = camera_args()
    frame = np.clip(seq[side][0], 0, 255)
    if dtype == "uint8":
        frame = frame.astype(np.uint8)
    else:
        rng = np.random.default_rng(7)
        frame = (frame + rng.random(frame.shape)).astype(np.float32)
    cam_j = openvo_tpu.StereoCamera(*args)
    cam_t = openvo_tpu_torch.StereoCamera(*args, device="cpu")
    fn = f"undistort_rectify_{side}"
    ref = np.asarray(getattr(cam_j, fn)(jnp.asarray(frame)))
    out = getattr(cam_t, fn)(torch.from_numpy(frame)).numpy()
    assert out.dtype == ref.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(out, ref)
    # the maps are fractional: every output pixel is a weighted sum of taps
    mx = cam_t.map_left[0] if side == "left" else cam_t.map_right[0]
    assert (mx != torch.round(mx)).float().mean() > 0.9
