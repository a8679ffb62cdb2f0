"""The port's step as one program: no host read anywhere in it, so that the
card can replay it as one CUDA graph (``openvo_tpu_torch/_graph.py``), and
the fallback against the frame before last computed on the device, as
JAX's ``lax.cond`` (``openvo_tpu/models/stereo_odometer.py:228-240``).

- ``make_fx`` in fake mode traces the whole stereo step at the 320x240
  test configuration, the rig's step over 2 cameras and one chunk of the
  stream over 2 frames, with no data-dependent guard: a host branch such
  as ``if bool(use2.any())`` stops such a trace. Each also with the loops
  JAX runs as ``lax.while_loop``s on: the step with the speckle filter
  (window 100, range 2, as ``bench.py:54-56``) and with the rigid clique
  and outlier pass (``filters``' thresholds), the chunk with speckle, the
  rig step with the filters; their loops trace as the operators
  ``openvo_torch::speckle_keep`` and ``openvo_torch::greedy_clique``;
  and the step with cv2.ORB's ranking, whose top-k reads the FAST-score
  keys of ORB's per-pixel stages (H9's second output);
- the step against JAX's jitted step from the same state
  (``state_from_jax_leaves``) when attempt 1 succeeds, when it fails with
  a frame before last (the fallback fires) and when it fails without one,
  and with the speckle filter or the filters on: ok, the skip code, every
  stat and c_T_w within 1e-4.

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
from openvo_tpu_torch.config import OdometerConfig, ORBParams
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
SPECKLE = {"speckleWindowSize": 100, "speckleRange": 2}   # bench.py:54-56
# the rigid clique and the outlier pass at the JAX package's test values
# (tests/test_odometer.py:228, :300)
FILTERS = dict(rigidity_threshold=0.05, outlier_threshold=0.01)
POSE_ATOL = 1e-4
N_FEATURE_FIELDS = 6
# trace case -> (SGBM settings over SGBM, odometer settings, the operator
# the trace must hold)
TRACES = {
    "default": ({}, {}, None),
    "speckle": (SPECKLE, {}, "openvo_torch.speckle_keep"),
    "filters": ({}, FILTERS, "openvo_torch.greedy_clique"),
    # cv2.ORB's ranking: detect's top-k reads H9's FAST-score keys too
    "cv2rank": ({}, {"orb": ORBParams(cv2_ranking=True)}, None),
}


def render(seed, n):
    return render_stereo_sequence(n_frames=n, img_size=IMG_SIZE, f=280.0,
                                  baseline=0.5, seed=seed, step=0.3,
                                  yaw_rate=0.006)


def frame(seq, i):
    return (np.clip(seq["left"][i], 0, 255).astype(np.uint8),
            np.clip(seq["right"][i], 0, 255).astype(np.uint8))


def camera_args(seq, sgbm=None):
    return (seq["K"], seq["dist"], seq["K"], seq["dist"],
            {"R": seq["R"], "T": seq["T"]}, {**SGBM, **(sgbm or {})},
            IMG_SIZE)


@pytest.fixture(scope="module")
def seq():
    return render(0, 3)


@pytest.fixture(scope="module")
def cam(seq):
    return openvo_tpu_torch.StereoCamera(*camera_args(seq), device="cpu")


@pytest.fixture(scope="module")
def speckle_cam(seq):
    return openvo_tpu_torch.StereoCamera(*camera_args(seq, SPECKLE),
                                         device="cpu")


def trace_case(case, cam, speckle_cam):
    """(camera, odometer config, the operator the trace must hold) of a
    case of TRACES."""
    sgbm, odo, op = TRACES[case]
    return speckle_cam if sgbm else cam, OdometerConfig(**odo), op


def trace(fn, *args, op=None):
    """Run ``fn`` eagerly (the device constants are made there), then
    trace it with fake tensors; a host read of a tensor's value raises.
    ``op``: an operator the traced graph must call."""
    fn(*args)
    graph = make_fx(fn, tracing_mode="fake",
                    _allow_non_fake_inputs=True)(*args)
    assert len(graph.graph.nodes) > 1000
    if op is not None:
        assert any(op in str(n.target) for n in graph.graph.nodes), op
    return graph


@pytest.mark.parametrize("case", TRACES)
def test_step_traces_without_a_host_read(seq, cam, speckle_cam, case):
    cam, cfg, op = trace_case(case, cam, speckle_cam)
    state = init_state(cam.cropped_shape, cfg.orb.max_keypoints, "cpu")
    trace(make_step(cam, cfg, False), state,
          *map(torch.from_numpy, frame(seq, 0)), op=op)


@pytest.mark.parametrize("case", ["default", "filters"])
def test_rig_step_traces_without_a_host_read(seq, cam, speckle_cam, case):
    cam, cfg, op = trace_case(case, cam, speckle_cam)
    pair = [torch.from_numpy(np.stack([a, a])) for a in frame(seq, 0)]
    trace(make_rig_step(cam, cfg), init_rig_state(cam, cfg, 2), *pair, op=op)


@pytest.mark.parametrize("case", ["default", "speckle"])
def test_stream_chunk_traces_without_a_host_read(seq, cam, speckle_cam,
                                                 case):
    cam, cfg, op = trace_case(case, cam, speckle_cam)
    stream = make_stream_fn(cam, cfg, chunk=2)
    pairs = [frame(seq, i) for i in range(2)]
    lefts, rights = (torch.from_numpy(np.stack(x)) for x in zip(*pairs))
    state = init_state(cam.cropped_shape, cfg.orb.max_keypoints, "cpu")
    trace(stream, state, lefts, rights, op=op)
    assert stream.captured is False   # the CPU runs eagerly


def jax_leaves(s):
    return [np.asarray(x) for x in jax.tree_util.tree_flatten(s)[0]]


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

    return step, {"s1": jax_leaves(s1), "s2": jax_leaves(s2),
                  "su": jax_leaves(su)}


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
    before = state_from_jax_leaves(leaves, "cpu")
    state, ok, stats = make_step(cam, OdometerConfig(), False)(
        before, *map(torch.from_numpy, frame(seq, i)))
    assert bool(stats["ok1"]) == want_ok1
    assert bool(stats["ok2"]) == want_ok2
    # the fallback's result is taken where attempt 1 failed with a frame
    # before last (the port's stat, which JAX's stats do not hold)
    assert bool(stats["use2"]) == (not want_ok1 and bool(before.has_prev))
    assert_step_matches_jax((j_state, j_ok, j_stats), (state, ok, stats))


def assert_step_matches_jax(j_out, out):
    """The port's step (state, ok, stats) against JAX's: ok, the skip
    code and every stat JAX's step returns equal, c_T_w and c_T_w_prev
    within POSE_ATOL."""
    (j_state, j_ok, j_stats), (state, ok, stats) = j_out, out
    assert bool(ok) == bool(j_ok)
    assert int(state.skip_code) == int(j_state.skip_code)
    assert set(j_stats) == set(STAT_NAMES) - {"use2"}
    for k in j_stats:
        assert int(stats[k]) == int(j_stats[k]), k
    np.testing.assert_allclose(state.c_T_w.numpy(), np.asarray(j_state.c_T_w),
                               rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(state.c_T_w_prev.numpy(),
                               np.asarray(j_state.c_T_w_prev), rtol=0,
                               atol=POSE_ATOL)


@pytest.mark.parametrize("case", ["speckle", "filters"])
def test_filtered_step_matches_jax(seq, cam, speckle_cam, case):
    """With the speckle filter or the rigid clique and outlier pass on,
    the port's step (H7 and H8's operators, their plain versions here)
    from JAX's state after frame 0 against JAX's jitted step on frame 1,
    and then on frame 2 from each one's own state."""
    sgbm, odo, _ = TRACES[case]
    jcam = openvo_tpu.StereoCamera(*camera_args(seq, sgbm))
    jcfg = JaxOdometerConfig(**odo)
    jstep = jax.jit(jax_make_step(jcam, jcfg, False))
    s = jstep(jax_init_state(jcam.cropped_shape, jcfg.orb.max_keypoints),
              *frame(seq, 0))[0]
    cam, cfg, _ = trace_case(case, cam, speckle_cam)
    step = make_step(cam, cfg, False)
    state = state_from_jax_leaves(jax_leaves(s), "cpu")
    for i in (1, 2):
        j_out = jstep(s, *frame(seq, i))
        out = step(state, *map(torch.from_numpy, frame(seq, i)))
        assert_step_matches_jax(j_out, out)
        s, state = j_out[0], out[0]


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
