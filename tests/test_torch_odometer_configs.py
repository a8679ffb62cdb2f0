"""The port's StereoOdometer against the JAX package's with an SGBM beyond
the default: 8 paths with the speckle filter on, over a few frames of a
small synthetic corridor. The same ok and skip_cause on every frame and
poses within the atol of tests/test_torch_odometer.py (disparities,
keypoints and descriptors are bit-equal; Kabsch sums run in another
order)."""

import numpy as np
import pytest

import openvo_tpu
import openvo_tpu_torch
from openvo_tpu.config import SGBMParams as JaxSGBMParams
from openvo_tpu.io.synthetic import render_stereo_sequence
from openvo_tpu_torch.config import SGBMParams

IMG_SIZE = (320, 240)
N = 4
POSE_ATOL = 1e-4
SGBM = dict(min_disparity=0, num_disparities=96, block_size=5, p1=200,
            p2=800, disp12_max_diff=1, pre_filter_cap=63,
            uniqueness_ratio=10, speckle_window_size=100, speckle_range=2,
            num_paths=8)


@pytest.fixture(scope="module")
def seq():
    return render_stereo_sequence(n_frames=N, img_size=IMG_SIZE, f=280.0,
                                  baseline=0.5, seed=0, step=0.3,
                                  yaw_rate=0.006)


def run(pkg, params, seq):
    port = {"device": "cpu"} if pkg is openvo_tpu_torch else {}
    cam = pkg.StereoCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                           {"R": seq["R"], "T": seq["T"]}, params, IMG_SIZE,
                           **port)
    odo = pkg.StereoOdometer(cam)
    out = []
    for i in range(N):
        ok = odo.update(np.clip(seq["left"][i], 0, 255).astype(np.uint8),
                        np.clip(seq["right"][i], 0, 255).astype(np.uint8))
        out.append((ok, odo.skip_cause, odo.current_pose(),
                    np.asarray(odo.current_disparity)))
    return out


def test_eight_paths_with_speckle_match_jax(seq):
    want = run(openvo_tpu, JaxSGBMParams(**SGBM), seq)
    got = run(openvo_tpu_torch, SGBMParams(**SGBM), seq)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], f"frame {i}: ok {g[0]} vs {w[0]}"
        assert g[1] == w[1], f"frame {i}: cause {g[1]!r} vs {w[1]!r}"
        np.testing.assert_array_equal(g[3], w[3], err_msg=f"frame {i}")
        np.testing.assert_allclose(g[2], w[2], rtol=0, atol=POSE_ATOL,
                                   err_msg=f"frame {i}")
    assert all(w[0] for w in want)
