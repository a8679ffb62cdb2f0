"""The traffic generator: the corridor repeats per seed, and equals the
NumPy corridor of ``openvo_tpu_torch/io/synthetic.py`` for one texture."""

import numpy as np
import torch

from vobench.harness import drive, render

CAMERA = {"width": 96, "height": 48, "fx": 55.5, "fy": 55.5, "cx": 47.5,
          "cy": 23.5, "baseline_m": 0.54}
MOTION = {"frames": 3, "step_m": 0.5, "yaw_rad": 0.004,
          "corridor_length_m": 80.0, "corridor_half_width_m": 7.0,
          "texture_px": 256}


def test_same_seed_same_frames_other_seed_other_frames():
    a = render.render_sequence(7, CAMERA, MOTION, 2, "cpu")
    b = render.render_sequence(7, CAMERA, MOTION, 2, "cpu")
    c = render.render_sequence(8, CAMERA, MOTION, 2, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[0][0], a[0][1])   # each camera its texture
    assert a[0].shape == (2, 3, 48, 96) and a[0].dtype == torch.uint8


def test_a_large_seed_is_taken():
    left, _, _ = render.render_sequence(2 ** 31 + 12345, CAMERA, MOTION, 1,
                                        "cpu")
    assert left.float().std() > 10


def test_views_equal_the_numpy_corridor():
    from openvo_tpu_torch.io import synthetic as syn

    tex = render.make_texture(3, "cpu", 256)
    K = render.intrinsics(CAMERA)
    poses = render.trajectory(3, 0.5, 0.004)
    mine = render.render_views(K, poses, render.corridor_planes(80.0, 7.0),
                               tex, 96, 48).numpy()
    for i, pose in enumerate(poses):
        ref, _ = syn.render_view(K, pose, syn.corridor_planes(80.0, 7.0),
                                 tex.numpy(), (96, 48))
        np.testing.assert_array_equal(mine[i], ref)
    np.testing.assert_allclose(poses, syn.camera_trajectory(3, 0.5, 0.004))


def test_playback_runs_forward_then_back():
    seq = [drive.frame_index(i, 4) for i in range(12)]
    assert seq == [0, 1, 2, 3, 3, 2, 1, 0, 0, 1, 2, 3]
