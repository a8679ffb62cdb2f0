"""The port's batched stages at the configurations off the int16,
speckle-off path, against ``jax.vmap`` of the JAX package's functions and
against the port's own single-frame calls, on the CPU at small sizes:

- the speckle filter over a (B, H, W) stack (real SGBM output, the
  spiral, random islands), its host syncs those of the slowest frame;
- block13's float32 cost volume and box sum over a stack of fractional
  pairs;
- ``sgbm_disparity16`` over a stack at block 13 and with speckle on;
- the rigid clique and the outlier pass over a batch of point clouds
  (cliques that stop at different steps, an empty mask, a NaN row);
- ``make_stream_fn`` with speckle on and at block 13, and ``RigOdometer``
  with both filters on over three different sequences, against JAX's
  stream and rig.

Every comparison is bit for bit but the poses: within SELF_ATOL (the
1e-5 of tests/test_parallel.py:270) of the port's own frame-by-frame or
one-camera odometer, and within JAX_ATOL of JAX's (the tolerance of
tests/test_torch_parallel.py: the port's single-frame Kabsch rounds once
from float64, JAX's in float32, 1.0e-5 apart after four frames here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvo_tpu
import openvo_tpu_torch
from openvo_tpu.config import OdometerConfig as JaxOdometerConfig
from openvo_tpu.config import ORBParams as JaxORBParams
from openvo_tpu.config import SGBMParams as JaxSGBMParams
from openvo_tpu.io.synthetic import render_stereo_sequence
from openvo_tpu.models import stereo_odometer as jodo
from openvo_tpu.ops import sgbm as jsgbm
from openvo_tpu.parallel import rig as jrig
from openvo_tpu.parallel import stream as jstream
from openvo_tpu.pose import outlier as joutlier
from openvo_tpu.pose import rigid_clique as jclique
from openvo_tpu_torch.config import (SKIP_KEYPOINTS, OdometerConfig,
                                     ORBParams, SGBMParams)
from openvo_tpu_torch.models import stereo_odometer as odo
from openvo_tpu_torch.ops import sgbm, sgbm_cuda
from openvo_tpu_torch.parallel.rig import RigOdometer
from openvo_tpu_torch.parallel.stream import make_stream_fn
from openvo_tpu_torch.pose import outlier, rigid_clique

IMG_SIZE = (256, 192)
D = 64
BASE = dict(num_disparities=D, block_size=5, p1=200, p2=800,
            disp12_max_diff=1, pre_filter_cap=63, uniqueness_ratio=10)
CONFIGS = {
    "speckle": dict(speckle_window_size=100, speckle_range=2),
    "block13": dict(block_size=13, p1=8 * 169, p2=32 * 169),
}
# the rig's filters: at 256x192 the corridor's depth is coarse, and the
# clique at the 0.05 m of tests/test_odometer.py:228 keeps fewer than 10
# points on most frames here; at 0.4 m some frames track and some skip
FILTERS = dict(rigidity_threshold=0.4, outlier_threshold=0.01)
SELF_ATOL = 1e-5
JAX_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, leaving the cores to the suite's other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def render(n_frames, seed=0, step=0.3, img_size=IMG_SIZE):
    return render_stereo_sequence(n_frames=n_frames, img_size=img_size,
                                  f=280.0, baseline=0.5, seed=seed,
                                  step=step, yaw_rate=0.004)


def u8(seq, side):
    return np.clip(seq[side], 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# the speckle filter over a stack
# ---------------------------------------------------------------------------


def spiral(H=96, W=128):
    """tests/test_torch_sgbm_configs.py's worst case: a 1 px wide spiral
    (one component that needs many min-scan rounds in JAX) and two
    single-pixel islands."""
    d = np.full((H, W), -16, np.int32)
    top, bot, lft, rgt = 2, H - 3, 2, W - 3
    while lft < rgt - 4 and top < bot - 4:
        d[top, lft:rgt + 1] = 80
        d[top:bot + 1, rgt] = 80
        d[bot, lft + 2:rgt + 1] = 80
        d[top + 2:bot + 1, lft] = 80
        top, bot, lft, rgt = top + 2, bot - 2, lft + 2, rgt - 2
    d[1, 0] = 80
    d[H - 1, W - 1] = 80
    return d, d >= 0


def islands(seed, H=96, W=128):
    """Blocky random disparities with noise and holes (as
    tests/test_torch_sgbm_configs.py's random islands)."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 4, (H // 8, W // 8)) * 40
    d = np.kron(coarse, np.ones((8, 8), np.int64)).astype(np.int32)
    d += rng.integers(-8, 9, (H, W)).astype(np.int32)
    return d, rng.random((H, W)) > 0.1


def real_maps():
    """The port's SGBM (speckle off) on three frames of the corridor."""
    seq = render(3, img_size=(160, 120))
    d = sgbm.sgbm_disparity16(torch.from_numpy(u8(seq, "left")),
                              torch.from_numpy(u8(seq, "right")),
                              SGBMParams(**dict(BASE, num_disparities=32)))
    d = d.numpy().astype(np.int32)
    return [(x, x >= 0) for x in d]


STACKS = {
    "real": (real_maps, 100),
    "spiral and islands": (lambda: [spiral(), (lambda d, v: (
        d[:, ::-1].copy(), v[:, ::-1].copy()))(*spiral()), islands(0),
        islands(1)], 60),
}


@pytest.mark.parametrize("stack", list(STACKS))
def test_speckle_filter_batched_matches_jax_vmap(stack):
    make, window = STACKS[stack]
    maps = make()
    d = np.stack([m[0] for m in maps])
    valid = np.stack([m[1] for m in maps])
    kw = dict(BASE, speckle_window_size=window, speckle_range=2)
    pj, pt = JaxSGBMParams(**kw), SGBMParams(**kw)
    want = np.asarray(jax.jit(jax.vmap(
        lambda x, v: jsgbm._speckle_filter(x, v, pj)))(jnp.asarray(d),
                                                       jnp.asarray(valid)))
    singles = []
    for x, v in maps:
        sgbm.speckle_filter.syncs = 0
        singles.append(sgbm.speckle_filter(torch.from_numpy(x),
                                           torch.from_numpy(v), pt).numpy())
        singles[-1] = (singles[-1], sgbm.speckle_filter.syncs)
    sgbm.speckle_filter.syncs = 0
    got = sgbm.speckle_filter(torch.from_numpy(d), torch.from_numpy(valid),
                              pt).numpy()
    np.testing.assert_array_equal(got, want)
    for i, (one, _) in enumerate(singles):
        np.testing.assert_array_equal(got[i], one, err_msg=f"frame {i}")
    # the batch runs its slowest frame's rounds once, not their sum
    rounds = [s for _, s in singles]
    assert sgbm.speckle_filter.syncs == max(rounds), rounds
    assert 0 < got.sum() < valid.sum()


def test_speckle_batch_syncs_are_the_slowest_frames():
    """Frames that converge in different numbers of rounds (the spiral
    merges in few hooking rounds, the islands need more): the batch pays
    the larger count once, not the sum."""
    kw = dict(BASE, speckle_window_size=60, speckle_range=2)
    pt = SGBMParams(**kw)
    counts = []
    maps = [spiral(), islands(2)]
    for x, v in maps:
        sgbm.speckle_filter.syncs = 0
        sgbm.speckle_filter(torch.from_numpy(x), torch.from_numpy(v), pt)
        counts.append(sgbm.speckle_filter.syncs)
    sgbm.speckle_filter.syncs = 0
    sgbm.speckle_filter(torch.from_numpy(np.stack([m[0] for m in maps])),
                        torch.from_numpy(np.stack([m[1] for m in maps])), pt)
    assert counts[0] != counts[1]
    assert sgbm.speckle_filter.syncs == max(counts) < sum(counts)


# ---------------------------------------------------------------------------
# block13's float32 cost volume and the SGBM over a stack
# ---------------------------------------------------------------------------


def fractional_pairs(n=3, img_size=(160, 96), shift=0.37):
    """``n`` frames of the corridor, both views resampled by ``shift`` px:
    every pixel fractional."""
    seq = render(n, img_size=img_size)

    def resample(img):
        img = np.clip(img, 0, 255).astype(np.float32)
        nxt = np.concatenate([img[..., 1:], img[..., -1:]], axis=-1)
        return ((1 - np.float32(shift)) * img
                + np.float32(shift) * nxt).astype(np.float32)

    return resample(seq["left"]), resample(seq["right"])


@pytest.mark.parametrize("block,cap", [(13, 63), (5, 400)])
def test_cost_volume_f32_batched_matches_jax_vmap(block, cap):
    left, right = fractional_pairs()
    lj = jax.vmap(lambda a: jsgbm.prefilter_xsobel(a, cap))(jnp.asarray(left))
    rj = jax.vmap(lambda a: jsgbm.prefilter_xsobel(a, cap))(
        jnp.asarray(right))
    assert sgbm.int16_sentinel(block, cap) is None
    want = np.asarray(jax.jit(jax.vmap(lambda a, b: jsgbm.block_sum(
        jsgbm.bt_cost_volume(a, b, 0, 32, block_size=block, cap=cap),
        block)))(lj, rj))
    lt, rt = torch.tensor(np.asarray(lj)), torch.tensor(np.asarray(rj))
    assert not torch.equal(lt, torch.round(lt))
    got = sgbm_cuda.cost_volume_f32(lt, rt, 0, 32, block, cap, 2 * cap <= 127)
    assert got.shape == want.shape == (3, 96, 160, 32)
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(3):
        assert torch.equal(got[i], sgbm_cuda.cost_volume_f32(
            lt[i], rt[i], 0, 32, block, cap, 2 * cap <= 127))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_sgbm_disparity16_batched_matches_jax_vmap(config):
    kw = dict(BASE, **CONFIGS[config])
    if config == "block13":
        left, right = fractional_pairs()
    else:
        seq = render(3, img_size=(160, 96))
        left, right = (u8(seq, s).astype(np.float32)
                       for s in ("left", "right"))
    pj, pt = JaxSGBMParams(**kw), SGBMParams(**kw)
    want = np.asarray(jax.jit(jax.vmap(
        lambda a, b: jsgbm.sgbm_disparity16(a, b, pj)))(jnp.asarray(left),
                                                        jnp.asarray(right)))
    got = sgbm.sgbm_disparity16(torch.from_numpy(left),
                                torch.from_numpy(right), pt)
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(3):
        assert torch.equal(got[i], sgbm.sgbm_disparity16(
            torch.from_numpy(left[i]), torch.from_numpy(right[i]), pt))
    assert (want >= 0).mean() > 0.3


# ---------------------------------------------------------------------------
# the pose filters over a batch of point clouds
# ---------------------------------------------------------------------------


def clouds():
    """Five members of 48 correspondences: a rigid scene with few outliers
    (a long clique), one with many (a short one), two rigid groups that
    tie, an empty mask, and a rigid scene with a NaN row."""
    rng = np.random.default_rng(11)
    n = 48
    src, dst, mask = [], [], []
    for member in range(5):
        a = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
        ang = rng.uniform(-0.2, 0.2)
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        b = (a @ R.T + rng.uniform(-1, 1, 3)).astype(np.float32)
        b += rng.normal(0, 0.004, b.shape).astype(np.float32)
        m = rng.random(n) > 0.1
        if member == 0:
            b[:3] += 2.0
        elif member == 1:
            b[:30] += rng.uniform(-2, 2, (30, 3)).astype(np.float32)
        elif member == 2:
            b[n // 2:] = a[n // 2:] + np.float32([0, 0, 3])
            b[:n // 2] = a[:n // 2] + np.float32([0.4, 0, 0])
            a[n // 2:] += np.float32([0, 0, 40])
            b[n // 2:] += np.float32([0, 0, 40])
            m[:] = True
        elif member == 3:
            m[:] = False
        else:
            a[7] = np.nan
        src.append(a)
        dst.append(b)
        mask.append(m)
    return np.stack(src), np.stack(dst), np.stack(mask)


def test_rigid_body_filter_batched_matches_jax_vmap():
    src, dst, mask = clouds()
    want = np.asarray(jax.jit(jax.vmap(
        lambda a, b, m: jclique.rigid_body_filter(a, b, m, 0.05)))(
        src, dst, mask))
    singles, sizes = [], []
    for i in range(len(src)):
        rigid_clique.rigid_body_filter.syncs = 0
        singles.append(rigid_clique.rigid_body_filter(
            torch.from_numpy(src[i]), torch.from_numpy(dst[i]),
            torch.from_numpy(mask[i]), 0.05).numpy())
        sizes.append(rigid_clique.rigid_body_filter.syncs)
    rigid_clique.rigid_body_filter.syncs = 0
    got = rigid_clique.rigid_body_filter(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask),
        0.05).numpy()
    assert got.shape == (5, 48) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.stack(singles))
    counts = got.sum(1)
    # cliques of different lengths, the tie to the first group, none for
    # the empty mask, the NaN row left out
    assert counts[0] > counts[1] > 0 and len(set(counts[[0, 1, 4]])) == 3
    np.testing.assert_array_equal(got[2], np.r_[np.ones(24), np.zeros(24)])
    assert counts[3] == 0 and got[4, 7] == 0
    # one host check a batch of steps for all members
    assert rigid_clique.rigid_body_filter.syncs == max(sizes)


def test_outlier_filter_batched_matches_jax_vmap():
    src, dst, mask = clouds()
    want = np.asarray(jax.jit(jax.vmap(
        lambda a, b, m: joutlier.outlier_filter(a, b, m, 0.01)))(
        src, dst, mask))
    got = outlier.outlier_filter(torch.from_numpy(src), torch.from_numpy(dst),
                                 torch.from_numpy(mask), 0.01).numpy()
    np.testing.assert_array_equal(got, want)
    for i in range(len(src)):
        np.testing.assert_array_equal(got[i], outlier.outlier_filter(
            torch.from_numpy(src[i]), torch.from_numpy(dst[i]),
            torch.from_numpy(mask[i]), 0.01).numpy(), err_msg=f"member {i}")
    # the NaN row empties its member's mask, the empty mask stays empty
    assert not got[3].any() and not got[4].any() and got[0].sum() >= 10


def test_masked_median_batched_matches_jax_vmap():
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(6, 16)).astype(np.float32)
    mask = rng.random((6, 16)) > 0.5
    mask[0] = False
    mask[1, :] = False
    mask[1, 3] = True
    vals[2, np.nonzero(mask[2])[0][0]] = np.nan
    want = np.asarray(jax.vmap(joutlier.masked_median)(vals, mask))
    got = outlier.masked_median(torch.from_numpy(vals),
                                torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[2]) and got[1] == vals[1, 3]


# ---------------------------------------------------------------------------
# the stream and the rig at these configurations, against JAX's
# ---------------------------------------------------------------------------


def cameras(seq, sgbm_change=None, filters=None):
    """(JAX camera, JAX config, port camera on the CPU, port config)."""
    args = (seq["K"], seq["dist"], seq["K"], seq["dist"],
            {"R": seq["R"], "T": seq["T"]})
    kw = dict(BASE, **(sgbm_change or {}))
    jcam = openvo_tpu.StereoCamera(*args, JaxSGBMParams(**kw), IMG_SIZE)
    tcam = openvo_tpu_torch.StereoCamera(*args, SGBMParams(**kw), IMG_SIZE,
                                         device="cpu")
    okw = dict(nfeatures=256, **(filters or {}))
    jcfg = JaxOdometerConfig(orb=JaxORBParams(nfeatures=256,
                                              max_keypoints=256), **okw)
    tcfg = OdometerConfig(orb=ORBParams(nfeatures=256, max_keypoints=256),
                          **okw)
    return jcam, jcfg, tcam, tcfg


def one_camera_run(tcam, tcfg, lefts, rights):
    """The port's single-frame odometer over the frames: ok, skip cause
    and c_T_w after each."""
    step = odo.make_step(tcam, tcfg, False)
    state = odo.init_state(tcam.cropped_shape, tcfg.orb.max_keypoints, "cpu")
    oks, codes, poses = [], [], []
    for left, right in zip(lefts, rights):
        state, ok, stats = step(state, torch.from_numpy(left),
                                torch.from_numpy(right))
        oks.append(bool(ok))
        codes.append(int(stats["skip_code"]))
        poses.append(state.c_T_w.numpy())
    return np.array(oks), np.array(codes), np.stack(poses)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_stream_matches_jax(config):
    n = 4
    seq = render(n)
    jcam, jcfg, tcam, tcfg = cameras(seq, CONFIGS[config])
    lefts, rights = u8(seq, "left"), u8(seq, "right")
    jstate = jodo.init_state(jcam.cropped_shape, jcfg.orb.max_keypoints)
    jend, (jok, jtraj) = jax.jit(jstream.make_stream_fn(jcam, jcfg, chunk=2))(
        jstate, jnp.asarray(lefts), jnp.asarray(rights))
    state = odo.init_state(tcam.cropped_shape, tcfg.orb.max_keypoints, "cpu")
    end, (ok, traj) = make_stream_fn(tcam, tcfg, chunk=2)(state, lefts,
                                                          rights)
    sok, scodes, straj = one_camera_run(tcam, tcfg, lefts, rights)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(ok.numpy(), sok)
    np.testing.assert_allclose(traj.numpy(), straj, rtol=0, atol=SELF_ATOL)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=0,
                               atol=JAX_ATOL)
    assert int(end.skip_code) == int(jend.skip_code) == scodes[-1]
    assert int(end.skipped) == int(jend.skipped)
    assert np.asarray(jok).all()


def test_rig_with_filters_matches_jax():
    """Three cameras on three sequences (textures and steps differ), both
    filters on, camera 2 blank at frame 2: each camera's ok, skip cause
    and pose as JAX's rig gives them, and as the port's one-camera
    odometer on that camera's frames."""
    n_frames, blank_frame, blank_cam = 4, 2, 2
    seqs = [render(n_frames, seed=c, step=s)
            for c, s in enumerate([0.3, 0.2, 0.3])]
    frames = []
    for i in range(n_frames):
        ls = [u8(s, "left")[i] for s in seqs]
        rs = [u8(s, "right")[i] for s in seqs]
        if i == blank_frame:
            ls[blank_cam] = np.zeros_like(ls[blank_cam])
            rs[blank_cam] = np.zeros_like(rs[blank_cam])
        frames.append((np.stack(ls), np.stack(rs)))
    jcam, jcfg, tcam, tcfg = cameras(seqs[0], filters=FILTERS)
    rj, rt = jrig.RigOdometer(jcam, 3, jcfg), RigOdometer(tcam, 3, tcfg)
    oks, codes, poses = [], [], []
    for i, (ls, rs) in enumerate(frames):
        okj, okt = rj.update(ls, rs), rt.update(ls, rs)
        np.testing.assert_array_equal(okt, okj, err_msg=f"frame {i}")
        np.testing.assert_array_equal(rt.last_stats["skip_code"],
                                      rj.last_stats["skip_code"],
                                      err_msg=f"frame {i}")
        np.testing.assert_allclose(rt.current_poses(), rj.current_poses(),
                                   rtol=0, atol=JAX_ATOL,
                                   err_msg=f"frame {i}")
        oks.append(okt)
        codes.append(rt.last_stats["skip_code"])
        poses.append(np.linalg.inv(rt.current_poses()))
    oks, codes, poses = np.stack(oks), np.stack(codes), np.stack(poses)
    for c in range(3):
        sok, scodes, straj = one_camera_run(tcam, tcfg,
                                            [f[0][c] for f in frames],
                                            [f[1][c] for f in frames])
        np.testing.assert_array_equal(oks[:, c], sok, err_msg=f"camera {c}")
        np.testing.assert_array_equal(codes[:, c], scodes,
                                      err_msg=f"camera {c}")
        np.testing.assert_allclose(poses[:, c], straj, rtol=0,
                                   atol=SELF_ATOL, err_msg=f"camera {c}")
    assert not oks[blank_frame, blank_cam]
    assert codes[blank_frame, blank_cam] == SKIP_KEYPOINTS
    assert oks[1:].sum() >= 4, oks
