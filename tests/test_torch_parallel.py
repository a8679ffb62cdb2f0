"""The port's batched stages and its stream and rig layers
(``openvo_tpu_torch/parallel/stream.py``, ``rig.py``) against the port's
own single-frame calls and against the JAX package, at the sizes of
tests/test_parallel.py (256x192, D=64, 256 keypoints):

- the batched ``extract`` gives each frame the single-frame ``extract``'s
  outputs bit for bit, and holds to JAX's ``vmap(extract)`` as the
  single-frame tests hold the port to JAX (disparity x16 bit-equal;
  keypoints equal as sets, rows bit-equal but for order swaps of near-tie
  Harris responses above level 0, see tests/test_torch_orb.py; above
  level 0 the same ulps can move the angle across a GET_VALUE rounding:
  one bit of one descriptor in 1137 here);
- the stream at chunk None/5/1 against JAX's stream (oks equal, poses
  within POSE_ATOL) and the port's frame-by-frame step (oks equal, poses
  within 1e-5);
- the rig against JAX's, on identical cameras and on three sequences with
  a blank frame (codes and oks equal, poses within POSE_ATOL);
- each kernel's plain version on a batch against frame-by-frame calls.
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
from openvo_tpu.parallel import rig as jrig
from openvo_tpu.parallel import stream as jstream
from openvo_tpu_torch.config import OdometerConfig, ORBParams, SGBMParams
from openvo_tpu_torch.models import stereo_odometer as odo
from openvo_tpu_torch.ops import orb_cuda, sgbm, sgbm_cuda
from openvo_tpu_torch.parallel.rig import RigOdometer
from openvo_tpu_torch.parallel.stream import make_stream_fn

IMG_SIZE = (256, 192)
SGBM = dict(num_disparities=64, block_size=5, p1=200, p2=800,
            disp12_max_diff=1, pre_filter_cap=63, uniqueness_ratio=10)
N = 5
POSE_ATOL = 1e-4
SELF_ATOL = 1e-5


def render(n_frames, seed=0, step=0.3):
    return render_stereo_sequence(n_frames=n_frames, img_size=IMG_SIZE,
                                  f=280.0, baseline=0.5, seed=seed,
                                  step=step, yaw_rate=0.004)


def u8(seq, side):
    return np.clip(seq[side], 0, 255).astype(np.uint8)


def cameras(seq):
    """(JAX camera, JAX config, port camera on the CPU, port config)."""
    args = (seq["K"], seq["dist"], seq["K"], seq["dist"],
            {"R": seq["R"], "T": seq["T"]})
    jcam = openvo_tpu.StereoCamera(*args, JaxSGBMParams(**SGBM), IMG_SIZE)
    tcam = openvo_tpu_torch.StereoCamera(*args, SGBMParams(**SGBM), IMG_SIZE,
                                         device="cpu")
    jcfg = JaxOdometerConfig(nfeatures=256, orb=JaxORBParams(
        nfeatures=256, max_keypoints=256))
    tcfg = OdometerConfig(nfeatures=256, orb=ORBParams(nfeatures=256,
                                                       max_keypoints=256))
    return jcam, jcfg, tcam, tcfg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module, so that its many small CPU ops
    leave the cores to the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq():
    return render(N)


@pytest.fixture(scope="module")
def setup(seq):
    return cameras(seq)


@pytest.fixture(scope="module")
def port_feats(seq, setup):
    """The port's batched extract of the N frames, and its single-frame
    extract of each."""
    _, _, tcam, tcfg = setup
    extract = odo.make_pipeline_fns(tcam, tcfg, False)["extract"]
    lefts = torch.from_numpy(u8(seq, "left"))
    rights = torch.from_numpy(u8(seq, "right"))
    return extract(lefts, rights), [extract(lefts[i], rights[i])
                                    for i in range(N)]


def test_batched_extract_equals_single_frames(port_feats):
    batched, single = port_feats
    assert batched.kp_valid.shape == (N, 256)
    for name in odo.FrameFeatures._fields:
        for i in range(N):
            assert torch.equal(getattr(batched, name)[i],
                               getattr(single[i], name)), (name, i)


def test_batched_extract_matches_jax_vmap(seq, setup, port_feats):
    jcam, jcfg, _, _ = setup
    extract = jodo.make_pipeline_fns(jcam, jcfg, False)["extract"]
    want = jax.jit(jax.vmap(extract))(jnp.asarray(u8(seq, "left")),
                                      jnp.asarray(u8(seq, "right")))
    got, _ = port_feats
    np.testing.assert_array_equal(
        np.round(got.disp.numpy() * 16), np.round(np.asarray(want.disp) * 16))
    for i in range(N):
        valid = np.asarray(want.kp_valid[i])
        np.testing.assert_array_equal(got.kp_valid[i].numpy(), valid)
        assert valid.sum() > 100
        xy_t, xy_j = got.kp_xy[i].numpy(), np.asarray(want.kp_xy[i])
        d_t, d_j = got.desc[i].numpy(), np.asarray(want.desc[i])

        def rows(xy, d):
            return {tuple(xy[k]): d[k] for k in np.nonzero(valid)[0]}

        rt, rj = rows(xy_t, d_t), rows(xy_j, d_j)
        assert rt.keys() == rj.keys(), f"frame {i}"
        moved = (xy_t != xy_j).any(1)
        assert moved.mean() <= 0.02, f"frame {i}: {moved.sum()} rows moved"
        # a descriptor may differ only above level 0 (fractional level-0
        # coordinates), where the resize's ulps move the angle: at most a
        # GET_VALUE index or two, a few bits, at 1% of the keypoints
        flipped = {xy: int(np.unpackbits(rt[xy] ^ rj[xy]).sum())
                   for xy in rt if (rt[xy] != rj[xy]).any()}
        assert all(x % 1 or y % 1 for x, y in flipped), flipped
        assert len(flipped) <= 0.01 * len(rt), flipped
        assert max(flipped.values(), default=0) <= 8, flipped


@pytest.fixture(scope="module")
def references(seq, setup):
    """JAX's stream over the N frames, and the port's odometer stepped
    frame by frame: (oks, c_T_w per frame) of each."""
    jcam, jcfg, tcam, tcfg = setup
    jstate = jodo.init_state(jcam.cropped_shape, jcfg.orb.max_keypoints)
    _, (jok, jtraj) = jax.jit(jstream.make_stream_fn(jcam, jcfg))(
        jstate, jnp.asarray(u8(seq, "left")), jnp.asarray(u8(seq, "right")))
    step = odo.make_step(tcam, tcfg, False)
    state = odo.init_state(tcam.cropped_shape, tcfg.orb.max_keypoints, "cpu")
    oks, poses = [], []
    for i in range(N):
        state, ok, _ = step(state, torch.from_numpy(u8(seq, "left")[i]),
                            torch.from_numpy(u8(seq, "right")[i]))
        oks.append(bool(ok))
        poses.append(state.c_T_w.numpy())
    return (np.asarray(jok), np.asarray(jtraj)), (np.array(oks),
                                                   np.stack(poses))


@pytest.mark.parametrize("chunk", [None, 5, 1])
def test_stream_matches_jax_and_stepping(seq, setup, references, chunk):
    _, _, tcam, tcfg = setup
    (jok, jtraj), (sok, straj) = references
    state = odo.init_state(tcam.cropped_shape, tcfg.orb.max_keypoints, "cpu")
    _, (ok, traj) = make_stream_fn(tcam, tcfg, chunk=chunk)(
        state, u8(seq, "left"), u8(seq, "right"))
    assert ok.shape == (N,) and traj.shape == (N, 4, 4)
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_allclose(traj.numpy(), jtraj, rtol=0, atol=POSE_ATOL)
    np.testing.assert_array_equal(ok.numpy(), sok)
    np.testing.assert_allclose(traj.numpy(), straj, rtol=0, atol=SELF_ATOL)
    assert jok.all()


def test_stream_rejects_an_indivisible_chunk(setup):
    _, _, tcam, tcfg = setup
    state = odo.init_state(tcam.cropped_shape, tcfg.orb.max_keypoints, "cpu")
    blank = np.zeros((N,) + IMG_SIZE[::-1], np.uint8)
    with pytest.raises(ValueError, match="divisible"):
        make_stream_fn(tcam, tcfg, chunk=2)(state, blank, blank)


def run_rigs(jcam, jcfg, tcam, tcfg, n_cams, frames):
    """Both rigs over ``frames`` ((lefts (N,H,W), rights) per step): per
    step (oks, skip codes) of each, and the final poses."""
    rj, rt = jrig.RigOdometer(jcam, n_cams, jcfg), RigOdometer(tcam, n_cams,
                                                                tcfg)
    steps = []
    for ls, rs in frames:
        want = rj.update(ls, rs), rj.last_stats["skip_code"]
        got = rt.update(ls, rs), rt.last_stats["skip_code"]
        steps.append((want, got))
    return steps, rj.current_poses(), rt.current_poses()


def test_rig_identical_cameras_match_jax(seq, setup):
    n_cams = 3
    frames = [(np.stack([u8(seq, "left")[i]] * n_cams),
               np.stack([u8(seq, "right")[i]] * n_cams)) for i in range(3)]
    steps, pj, pt = run_rigs(*setup, n_cams, frames)
    for i, ((okj, cj), (okt, ct)) in enumerate(steps):
        assert okt.shape == (n_cams,) and okt.dtype == bool
        np.testing.assert_array_equal(okt, okj, err_msg=f"frame {i}")
        np.testing.assert_array_equal(ct, cj, err_msg=f"frame {i}")
        assert okt.all()
    assert pt.shape == (n_cams, 4, 4) and pt.dtype == np.float64
    np.testing.assert_allclose(pt, pj, rtol=0, atol=POSE_ATOL)
    for c in range(1, n_cams):
        np.testing.assert_allclose(pt[c], pt[0], rtol=0, atol=SELF_ATOL)
    assert pt[0][2, 3] > 0.3


def test_rig_heterogeneous_sequences_match_jax():
    """Three cameras on three sequences (textures and steps differ),
    camera 2 blank at frame 2: each camera's state machine as JAX's, the
    blank camera skipping as ``keypoints`` and recovering at frame 3."""
    from openvo_tpu_torch.config import SKIP_KEYPOINTS

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
    steps, pj, pt = run_rigs(*cameras(seqs[0]), 3, frames)
    for i, ((okj, cj), (okt, ct)) in enumerate(steps):
        np.testing.assert_array_equal(okt, okj, err_msg=f"frame {i}")
        np.testing.assert_array_equal(ct, cj, err_msg=f"frame {i}")
        assert okt.sum() == (2 if i == blank_frame else 3), (i, okt)
    assert steps[blank_frame][1][1][blank_cam] == SKIP_KEYPOINTS
    np.testing.assert_allclose(pt, pj, rtol=0, atol=POSE_ATOL)
    assert abs(pt[0][2, 3] - pt[1][2, 3]) > 0.2


# ---------------------------------------------------------------------------
# the kernels' plain versions on a batch
# ---------------------------------------------------------------------------

B = 3


def prefiltered_batch(H=40, W=96):
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (B, H, W + 12)).astype(np.float32)
    left = torch.from_numpy(base[:, :, 6:6 + W].copy())
    right = torch.from_numpy(base[:, :, :W].copy())
    return sgbm.prefilter_xsobel(left, 63), sgbm.prefilter_xsobel(right, 63)


def assert_frames_equal(batched, single):
    batched = batched if isinstance(batched, tuple) else (batched,)
    for i, one in enumerate(single):
        one = one if isinstance(one, tuple) else (one,)
        for a, b in zip(batched, one, strict=True):
            assert torch.equal(a[i], b), i


@pytest.mark.parametrize("band", [None, (3, True, False)])
def test_plain_h1_on_a_batch_equals_frames(band):
    lp, rp = prefiltered_batch()
    args = (0, 32, 5, sgbm.int16_sentinel(5, 63), 400, 1600, True, band)
    assert_frames_equal(sgbm_cuda.cost_hsweep(lp, rp, *args),
                        [sgbm_cuda.cost_hsweep(lp[i], rp[i], *args)
                         for i in range(B)])


@pytest.mark.parametrize("grid", ["int16", "float32"])
@pytest.mark.parametrize("kind", ["trio", "both ways", "carry"])
def test_plain_h2_on_a_batch_equals_frames(grid, kind):
    lp, rp = prefiltered_batch()
    if grid == "int16":
        C, _ = sgbm_cuda.cost_hsweep(lp, rp, 0, 32, 5, 504, 400, 1600, True)
        pen = (400, 1600)
    else:
        C = sgbm_cuda.cost_volume_f32(lp, rp, 0, 32, 13, 63, True)
        pen = (8 * 169, 32 * 169)
    if kind == "carry":
        init = torch.stack([sgbm_cuda.vsweep(c[:20], *pen, True,
                                             return_carry=True)[1]
                            for c in C])
        kw = dict(init_carry=init, return_carry=True)
        C = C[:, 20:].contiguous()
    else:
        kw = dict(up=kind == "both ways" and grid == "int16")
    assert_frames_equal(sgbm_cuda.vsweep(C, *pen, True, **kw),
                        [sgbm_cuda.vsweep(C[i], *pen, True,
                                          **{k: (v[i] if k == "init_carry"
                                                 else v)
                                             for k, v in kw.items()})
                         for i in range(B)])


def test_plain_h5_and_h3_on_a_batch_equal_frames():
    lp, rp = prefiltered_batch()
    wta = (0, 10, 1)
    C, s1 = sgbm_cuda.cost_hsweep(lp, rp, 0, 32, 5, 504, 400, 1600, True)
    s1 = sgbm_cuda.vsweep(C, 400, 1600, True, acc=s1)
    assert_frames_equal(
        sgbm_cuda.hsweep_wta_lr(C, s1, None, 400, 1600, *wta),
        [sgbm_cuda.hsweep_wta_lr(C[i], s1[i], None, 400, 1600, *wta)
         for i in range(B)])
    pen = (8 * 169, 32 * 169)
    Cf = sgbm_cuda.cost_volume_f32(lp, rp, 0, 32, 13, 63, True)
    s1f = sgbm_cuda.hsweep(Cf, *pen)
    assert_frames_equal(s1f, [sgbm_cuda.hsweep(Cf[i], *pen)
                              for i in range(B)])
    sv = sgbm_cuda.vsweep(Cf, *pen, True)
    svu = sgbm_cuda.vsweep(Cf, *pen, True, down=False, up=True)
    assert_frames_equal(
        sgbm_cuda.hsweep_wta_lr(Cf, s1f, sv, *pen, *wta, svu),
        [sgbm_cuda.hsweep_wta_lr(Cf[i], s1f[i], sv[i], *pen, *wta, svu[i])
         for i in range(B)])


def test_plain_h4_on_a_batch_equals_frames():
    """Frames with different numbers of valid keypoints, levels and
    windows clamped at the edges."""
    rng = np.random.default_rng(3)
    nl, H, W, K = 4, 60, 80, 40
    stack = torch.from_numpy(rng.uniform(0, 255, (B, nl, H, W))
                             .astype(np.float32))
    octave = torch.from_numpy(rng.integers(-1, nl + 1, (B, K)))
    xy = torch.from_numpy(rng.integers(-3, 85, (B, K, 2)))
    ang = torch.from_numpy(rng.uniform(-np.pi, np.pi, (B, K))
                           .astype(np.float32))
    valid = torch.from_numpy(np.arange(K)[None, :]
                             < np.array([[K], [7], [0]]))
    args = (stack, octave, xy, torch.cos(ang), torch.sin(ang), valid)
    out = orb_cuda.brief_describe(*args)
    assert out.shape == (B, K, 32)
    assert_frames_equal(out, [orb_cuda.brief_describe(*(a[i] for a in args))
                              for i in range(B)])
    assert not out[2].any()
