"""The port's step as one program: no host read anywhere in it, so that the
card can replay it as one CUDA graph (``openvo_tpu_torch/_graph.py``), and
the fallback against the frame before last computed on the device, as
JAX's ``lax.cond`` (``openvo_tpu/models/stereo_odometer.py:228-240``).

- ``make_fx`` in fake mode traces the whole stereo step at the 320x240
  test configuration, the rig's step over 2 cameras and one chunk of the
  stream over 2 frames, with no data-dependent guard: a host branch such
  as ``if bool(use2.any())`` stops such a trace;
- the step against JAX's jitted step from the same state
  (``state_from_jax_leaves``) when attempt 1 succeeds, when it fails with
  a frame before last (the fallback fires) and when it fails without one:
  ok, the skip code, every stat and c_T_w within 1e-4.

The captured replay itself needs the card (``chip_smoke.py`` holds it to
the eager run there).
"""

import jax
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

import openvo_tpu
import openvo_tpu_torch
from openvo_tpu.config import OdometerConfig as JaxOdometerConfig
from openvo_tpu.io.synthetic import render_stereo_sequence
from openvo_tpu.models.stereo_odometer import init_state as jax_init_state
from openvo_tpu.models.stereo_odometer import make_step as jax_make_step
from openvo_tpu_torch import _graph
from openvo_tpu_torch.config import OdometerConfig
from openvo_tpu_torch.models.stereo_odometer import (STAT_NAMES,
                                                     init_state, make_step,
                                                     state_from_jax_leaves,
                                                     state_leaves)
from openvo_tpu_torch.parallel.rig import init_rig_state, make_rig_step
from openvo_tpu_torch.parallel.stream import make_stream_fn

IMG_SIZE = (320, 240)
SGBM = {
    "minDisparity": 0, "numDisparities": 96, "blockSize": 5,
    "P1": 200, "P2": 800, "disp12MaxDiff": 1, "preFilterCap": 63,
    "uniquenessRatio": 10, "speckleWindowSize": 0, "speckleRange": 0,
}
POSE_ATOL = 1e-4
N_FEATURE_FIELDS = 6


def render(seed, n):
    return render_stereo_sequence(n_frames=n, img_size=IMG_SIZE, f=280.0,
                                  baseline=0.5, seed=seed, step=0.3,
                                  yaw_rate=0.006)


def frame(seq, i):
    return (np.clip(seq["left"][i], 0, 255).astype(np.uint8),
            np.clip(seq["right"][i], 0, 255).astype(np.uint8))


def camera_args(seq):
    return (seq["K"], seq["dist"], seq["K"], seq["dist"],
            {"R": seq["R"], "T": seq["T"]}, SGBM, IMG_SIZE)


@pytest.fixture(scope="module")
def seq():
    return render(0, 3)


@pytest.fixture(scope="module")
def cam(seq):
    return openvo_tpu_torch.StereoCamera(*camera_args(seq), device="cpu")


def trace(fn, *args):
    """Run ``fn`` eagerly (the device constants are made there), then
    trace it with fake tensors; a host read of a tensor's value raises."""
    fn(*args)
    return make_fx(fn, tracing_mode="fake",
                   _allow_non_fake_inputs=True)(*args)


def test_step_traces_without_a_host_read(seq, cam):
    cfg = OdometerConfig()
    state = init_state(cam.cropped_shape, cfg.orb.max_keypoints, "cpu")
    graph = trace(make_step(cam, cfg, False), state,
                  *map(torch.from_numpy, frame(seq, 0)))
    assert len(graph.graph.nodes) > 1000


def test_rig_step_traces_without_a_host_read(seq, cam):
    cfg = OdometerConfig()
    pair = [torch.from_numpy(np.stack([a, a])) for a in frame(seq, 0)]
    graph = trace(make_rig_step(cam, cfg), init_rig_state(cam, cfg, 2),
                  *pair)
    assert len(graph.graph.nodes) > 1000


def test_stream_chunk_traces_without_a_host_read(seq, cam):
    cfg = OdometerConfig()
    stream = make_stream_fn(cam, cfg, chunk=2)
    pairs = [frame(seq, i) for i in range(2)]
    lefts, rights = (torch.from_numpy(np.stack(x)) for x in zip(*pairs))
    state = init_state(cam.cropped_shape, cfg.orb.max_keypoints, "cpu")
    graph = trace(stream, state, lefts, rights)
    assert len(graph.graph.nodes) > 1000
    assert stream.captured is False   # the CPU runs eagerly


@pytest.fixture(scope="module")
def jax_states(seq):
    """JAX's jitted step and the leaves of its states: after frame 0
    (``s1``), after frames 0-1 (``s2``), and after frame 0 of another
    sequence (``su``: an unrelated texture)."""
    jcam = openvo_tpu.StereoCamera(*camera_args(seq))
    step = jax.jit(jax_make_step(jcam, JaxOdometerConfig(), False))
    s0 = jax_init_state(jcam.cropped_shape,
                        JaxOdometerConfig().orb.max_keypoints)
    s1 = step(s0, *frame(seq, 0))[0]
    s2 = step(s1, *frame(seq, 1))[0]
    su = step(s0, *frame(render(7, 1), 0))[0]

    def leaves(s):
        return [np.asarray(x) for x in jax.tree_util.tree_flatten(s)[0]]

    return step, {"s1": leaves(s1), "s2": leaves(s2), "su": leaves(su)}


# case -> (the state: JAX's, cur swapped for the unrelated frame's or
# not; the frame fed; ok1 and the fallback's ok)
CASES = {
    "attempt1_tracks": ("s2", False, 2, True, False),
    "fallback_fires": ("s2", True, 2, False, True),
    "no_frame_before_last": ("s1", True, 1, False, False),
}


@pytest.mark.parametrize("case", CASES)
def test_device_fallback_matches_jax_cond(seq, cam, jax_states, case):
    start, swap, i, want_ok1, want_ok2 = CASES[case]
    jstep, states = jax_states
    leaves = list(states[start])
    if swap:
        leaves[:N_FEATURE_FIELDS] = states["su"][:N_FEATURE_FIELDS]
    treedef = jax.tree_util.tree_structure(
        jax_init_state(cam.cropped_shape, 512))
    j_state, j_ok, j_stats = jstep(
        jax.tree_util.tree_unflatten(treedef, leaves), *frame(seq, i))
    state, ok, stats = make_step(cam, OdometerConfig(), False)(
        state_from_jax_leaves(leaves, "cpu"),
        *map(torch.from_numpy, frame(seq, i)))
    assert bool(stats["ok1"]) == want_ok1
    assert bool(stats["ok2"]) == want_ok2
    assert bool(ok) == bool(j_ok)
    assert int(state.skip_code) == int(j_state.skip_code)
    for k in STAT_NAMES:
        assert int(stats[k]) == int(j_stats[k]), k
    np.testing.assert_allclose(state.c_T_w.numpy(), np.asarray(j_state.c_T_w),
                               rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(state.c_T_w_prev.numpy(),
                               np.asarray(j_state.c_T_w_prev), rtol=0,
                               atol=POSE_ATOL)


def test_attempts_on_the_empty_state_leave_no_nan(seq, cam):
    """Frame 0: both attempts run against the zero state and fit NaN; no
    NaN reaches the state or the stats."""
    cfg = OdometerConfig()
    state = init_state(cam.cropped_shape, cfg.orb.max_keypoints, "cpu")
    new, ok, stats = make_step(cam, cfg, False)(
        state, *map(torch.from_numpy, frame(seq, 0)))
    assert bool(ok) and not bool(stats["ok1"]) and not bool(stats["ok2"])
    assert torch.equal(new.c_T_w, torch.eye(4))
    for x in new:
        if torch.is_tensor(x) and x.is_floating_point():
            assert torch.isfinite(x).all()
    assert torch.isfinite(new.cur.img).all() and torch.isfinite(
        new.cur.kp_xy).all()


def test_capture_is_not_used_on_the_cpu(seq, cam):
    """On the CPU the odometer and the stream run eagerly, and
    disable_capture nests."""
    odo = openvo_tpu_torch.StereoOdometer(cam)
    assert odo.update(*frame(seq, 0)) and odo.captured is False
    with _graph.disable_capture():
        with _graph.disable_capture():
            assert not _graph.capture_enabled()
        assert not _graph.capture_enabled()
    assert _graph.capture_enabled()


def test_a_second_odometer_keeps_the_first_ones_state(seq, cam):
    """A captured step's static buffers hold one odometer's state at a
    time: when another odometer of the camera takes the step, the holder
    keeps a copy of its state (``StereoOdometer._claim``)."""
    first = openvo_tpu_torch.StereoOdometer(cam)
    second = openvo_tpu_torch.StereoOdometer(cam)
    first.update(*frame(seq, 0))
    step = _graph.CapturedStep(None)
    step.state = first.state   # as after a replay for `first`
    first._claim(step)
    assert first.state is step.state
    second._claim(step)
    assert first.state is not step.state
    for a, b in zip(state_leaves(first.state), state_leaves(step.state)):
        assert torch.equal(a, b)
    second._claim(step)   # its own step again: nothing to save
    assert step.holder() is second
