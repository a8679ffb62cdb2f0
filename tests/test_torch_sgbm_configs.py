"""The port's SGBM beyond the default configuration, against the JAX
package's CPU path (the tier-1 oracle): non-integer images (the JAX
package's bfloat16 cost arithmetic), 4 and 8 paths, configurations without
an int16 sentinel (float32 on the x1 grid, in JAX's order of operations),
the speckle filter, and the partial scans each kernel's plain version
computes. Integer outputs are bit-equal; the port's int16-path partial
scans are twice JAX's (the port keeps the x2 grid there), its float32
ones equal JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvo_tpu
import openvo_tpu_torch
from openvo_tpu.config import SGBMParams as JaxSGBMParams
from openvo_tpu.io.synthetic import render_stereo_sequence
from openvo_tpu.ops import sgbm as jsgbm
from openvo_tpu_torch.config import SGBMParams
from openvo_tpu_torch.ops import sgbm, sgbm_cuda


def textured_pair(H, W, shift=7.0, seed=0, integer=True):
    """A textured pair, right = left shifted by ``shift`` px. With
    ``integer=False`` the texture is not rounded and the shift's fraction
    resamples it linearly: every pixel is fractional, as after a
    distorting camera's remap."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H, W + 40)).astype(np.float32)
    base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 0)) / 3
    if integer:
        base = np.round(base)
    s, t = int(shift), np.float32(shift - int(shift))
    right = (1 - t) * base[:, 20 + s:20 + s + W] + t * base[:, 21 + s:21 + s + W]
    return base[:, 20:20 + W].copy(), right.astype(np.float32)


def params_kw(D=64, block=5, **change):
    kw = dict(min_disparity=0, num_disparities=D, block_size=block, p1=200,
              p2=800, disp12_max_diff=1, pre_filter_cap=63,
              uniqueness_ratio=10)
    kw.update(change)
    return kw


def with_disparities(params, D):
    """``params`` with D disparities: SGBMParams takes multiples of 16
    (OpenCV's rule), the SGBM functions and kernels any D in [1, 1024]."""
    object.__setattr__(params, "num_disparities", D)
    return params


def jax_disp16(left, right, kw):
    return np.asarray(jsgbm.sgbm_disparity16(
        jnp.asarray(left), jnp.asarray(right), JaxSGBMParams(**kw)))


def port_disp16(left, right, kw):
    return sgbm.sgbm_disparity16(torch.from_numpy(left),
                                 torch.from_numpy(right),
                                 SGBMParams(**kw)).numpy()


def prefiltered(left, right, cap):
    lj = jsgbm.prefilter_xsobel(jnp.asarray(left), cap)
    rj = jsgbm.prefilter_xsobel(jnp.asarray(right), cap)
    return lj, rj, torch.tensor(np.asarray(lj)), torch.tensor(np.asarray(rj))


@pytest.mark.parametrize("cap,block,min_disp", [
    (63, 5, 0), (63, 7, 16), (101, 5, 0)])   # cap 101: float32 BT
def test_raw_costs_match_jax_on_non_integer_images(cap, block, min_disp):
    """The raw x2 cost and H1's box-summed C equal the JAX volumes on
    fractional images, where an exact float32 cost differs from JAX's
    bfloat16 one in a few percent of the elements."""
    left, right = textured_pair(48, 120, shift=7.4, integer=False)
    lj, rj, lt, rt = prefiltered(left, right, cap)
    assert not np.array_equal(np.asarray(lj), np.round(np.asarray(lj)))
    D, bf16 = 32, 2 * cap <= 127
    sent = sgbm.int16_sentinel(block, cap)
    raw = jsgbm.bt_cost_volume(lj, rj, min_disp, D, block_size=1, cap=cap)
    ours = sgbm_cuda.bt_cost_volume2(lt, rt, min_disp, D,
                                     sgbm.int16_sentinel(1, cap), bf16)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(raw))
    Cj = jsgbm.block_sum(jsgbm.bt_cost_volume(lj, rj, min_disp, D,
                                              block_size=block, cap=cap),
                         block)
    C, _ = sgbm_cuda.cost_hsweep(lt, rt, min_disp, D, block, sent, 400, 1600,
                                 bf16)
    np.testing.assert_array_equal(C.numpy(), np.asarray(Cj))
    if bf16:
        exact = sgbm_cuda.bt_cost_volume2(lt, rt, min_disp, D, 600, False)
        assert (exact.numpy() != np.asarray(raw)).mean() > 0.01


CONFIGS = {
    "4paths": (params_kw(num_paths=4), True),
    "8paths": (params_kw(num_paths=8), True),
    # no int16 sentinel at cap 63: int32 costs, H5, H3 over int32
    "block13": (params_kw(block=13, p1=8 * 169, p2=32 * 169), True),
    "block13-8paths": (params_kw(D=48, block=13, p1=8 * 169, p2=32 * 169,
                                 num_paths=8), True),
    # no sentinel at block 5 and float32 BT arithmetic
    "cap400": (params_kw(pre_filter_cap=400), True),
    "speckle": (params_kw(speckle_window_size=100, speckle_range=2), True),
    "non-integer": (params_kw(), False),
    "non-integer-8paths-speckle": (params_kw(
        D=48, num_paths=8, speckle_window_size=100, speckle_range=2), False),
    "d48-4paths": (params_kw(D=48, num_paths=4, min_disparity=-8), True),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_configurations_bit_equal_to_jax(name):
    kw, integer = CONFIGS[name]
    left, right = textured_pair(112, 240, shift=7.6 if not integer else 7,
                                seed=len(name), integer=integer)
    ref = jax_disp16(left, right, kw)
    out = port_disp16(left, right, kw)
    assert out.dtype == np.int16
    np.testing.assert_array_equal(out, ref)
    # the comparison is not vacuous: most pixels carry a valid disparity
    assert (ref > (kw["min_disparity"] - 1) * 16).mean() > 0.3


def _scan_pair(block, cap=63):
    """JAX's box-summed cost (int16 x2, or float32 x1 without a sentinel)
    and the port's (int16 x2, or float32 x1) for one textured pair."""
    left, right = textured_pair(40, 96, seed=block)
    lj, rj, lt, rt = prefiltered(left, right, cap)
    sent = sgbm.int16_sentinel(block, cap)
    Cj = jsgbm.block_sum(jsgbm.bt_cost_volume(lj, rj, 0, 32,
                                              block_size=block, cap=cap),
                         block)
    if sent is None:
        C = sgbm_cuda.cost_volume_f32(lt, rt, 0, 32, block, cap, True)
        np.testing.assert_array_equal(C.numpy(), np.asarray(Cj))
    else:
        C, _ = sgbm_cuda.cost_hsweep(lt, rt, 0, 32, block, sent, 2, 4, True)
    return Cj, C


@pytest.mark.parametrize("block", [5, 13])
@pytest.mark.parametrize("diagonals,reverse", [
    (True, True), (False, False), (False, True)])
def test_vertical_partials_are_twice_jax(block, diagonals, reverse):
    """H2's variants: the bottom-up trio (8 paths) and the straight line
    either way (4 paths), over int16 costs (block 5: twice JAX's) and
    float32 costs (block 13, no sentinel: equal to JAX's)."""
    Cj, C = _scan_pair(block)
    p1, p2 = 8 * block * block, 32 * block * block
    xshifts = (0, 1, -1) if diagonals else (0,)
    ref = np.asarray(jsgbm._scan_dirs(Cj, xshifts, float(p1), float(p2),
                                      reverse))
    if C.dtype == torch.int16:
        p1, p2, ref = 2 * p1, 2 * p2, 2 * ref
    sv = sgbm_cuda.vsweep(C, p1, p2, diagonals, down=not reverse,
                          up=reverse)
    np.testing.assert_array_equal(sv.numpy(), ref)


@pytest.mark.parametrize("reverse", [False, True])
def test_hsweep_is_twice_jax(reverse):
    """The horizontal scans over the float32 cost of a configuration
    without a sentinel equal JAX's: H5 left to right, and right to left
    the scan H3 runs."""
    Cj, C = _scan_pair(13)
    p1, p2 = 8 * 169, 32 * 169
    ref = jnp.swapaxes(jsgbm._scan_dirs(jnp.swapaxes(Cj, 0, 1), (0,),
                                        float(p1), float(p2), reverse), 0, 1)
    if reverse:
        L = sgbm_cuda.scan_f32(C.transpose(0, 1), 0, p1, p2,
                               reverse=True).transpose(0, 1)
    else:
        L = sgbm_cuda.hsweep(C, p1, p2)
    np.testing.assert_array_equal(L.numpy(), np.asarray(ref))


def corridor_pair(shift=0.37, img_size=(240, 96)):
    """Frame 0 of the synthetic corridor, both views resampled linearly by
    a ``shift`` px horizontal shift: every pixel fractional."""
    seq = render_stereo_sequence(n_frames=1, img_size=img_size, f=220.0,
                                 baseline=0.4, seed=0)

    def resample(img):
        img = np.clip(img, 0, 255).astype(np.float32)
        nxt = np.concatenate([img[:, 1:], img[:, -1:]], axis=1)
        return ((1 - np.float32(shift)) * img
                + np.float32(shift) * nxt).astype(np.float32)

    return resample(seq["left"][0]), resample(seq["right"][0])


@pytest.mark.parametrize("block,cap", [(13, 63), (5, 400)])
def test_float32_costs_equal_jax_on_non_integer_images(block, cap):
    """Without an int16 sentinel the raw float32 BT cost (bfloat16 formula
    at cap 63, float32 at cap 400) and its box sum equal JAX's
    ``bt_cost_volume`` + ``block_sum`` bit for bit on a fractional pair,
    where the doubled and truncated x2 cost does not."""
    left, right = corridor_pair()
    lj, rj, lt, rt = prefiltered(left, right, cap)
    assert sgbm.int16_sentinel(block, cap) is None
    raw = np.asarray(jsgbm.bt_cost_volume(lj, rj, 0, 32, block_size=block,
                                          cap=cap))
    ours = sgbm_cuda.cost_volume_f32(lt, rt, 0, 32, 1, cap, 2 * cap <= 127)
    np.testing.assert_array_equal(ours.numpy(), raw)
    assert (np.floor(2 * raw) != 2 * raw).mean() > 0.01
    Cj = np.asarray(jsgbm.block_sum(jnp.asarray(raw), block))
    C = sgbm_cuda.cost_volume_f32(lt, rt, 0, 32, block, cap, 2 * cap <= 127)
    np.testing.assert_array_equal(C.numpy(), Cj)


FRACTIONAL = {
    "5paths": params_kw(D=32, block=13, p1=8 * 169, p2=32 * 169),
    "8paths": params_kw(D=32, block=13, p1=8 * 169, p2=32 * 169,
                        num_paths=8),
    "4paths": params_kw(D=32, block=13, p1=8 * 169, p2=32 * 169,
                        num_paths=4),
    "speckle": params_kw(D=32, block=13, p1=8 * 169, p2=32 * 169,
                         speckle_window_size=50, speckle_range=2),
}


@pytest.mark.parametrize("name", list(FRACTIONAL))
def test_no_sentinel_disparity_equals_jax_on_a_fractional_pair(name):
    """blockSize 13 (no int16 sentinel) on the corridor frame shifted by
    0.37 px: the float32 path gives JAX's disp16 bit for bit."""
    left, right = corridor_pair()
    kw = FRACTIONAL[name]
    ref = jax_disp16(left, right, kw)
    np.testing.assert_array_equal(port_disp16(left, right, kw), ref)
    assert (ref > -16).mean() > 0.3


@pytest.mark.parametrize("D,num_paths", [
    (1, 5), (33, 8), (128, 4), (256, 5), (1024, 8)])
def test_float32_path_at_kernel_edges_equals_jax(D, num_paths):
    """blockSize 13 (the float32 path, H3 over float32 C with and without
    the bottom-up partial apart) on a fractional pair at every number of
    disparities a lane of the warp walk holds: JAX's disp16 bit for bit."""
    left, right = textured_pair(8, D + 76 if D > 128 else 100, shift=7.4,
                                seed=D, integer=False)
    kw = params_kw(D=16, block=13, p1=8 * 169, p2=32 * 169,
                   num_paths=num_paths)
    ref = jsgbm.sgbm_disparity16(jnp.asarray(left), jnp.asarray(right),
                                 with_disparities(JaxSGBMParams(**kw), D))
    out = sgbm.sgbm_disparity16(torch.from_numpy(left),
                                torch.from_numpy(right),
                                with_disparities(SGBMParams(**kw), D))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def speckle_params(window=100, rng_=2):
    kw = params_kw(speckle_window_size=window, speckle_range=rng_)
    return JaxSGBMParams(**kw), SGBMParams(**kw)


def assert_speckle_matches_jax(d, valid, window=100, rng_=2):
    pj, pt = speckle_params(window, rng_)
    ref = np.asarray(jax.jit(lambda x, v: jsgbm._speckle_filter(x, v, pj))(
        jnp.asarray(d), jnp.asarray(valid)))
    ours = sgbm.speckle_filter(torch.from_numpy(d), torch.from_numpy(valid),
                               pt).numpy()
    np.testing.assert_array_equal(ours, ref)
    return ref


def test_speckle_filter_matches_jax_on_a_spiral():
    """The shape of tests/test_sgbm.py's worst case: a 1 px wide spiral
    that needs many min-scan rounds in JAX is one component here too, and
    the small islands go."""
    H, W = 96, 128
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
    keep = assert_speckle_matches_jax(d, d >= 0)
    assert keep.sum() > 100 and not keep[1, 0] and not keep[H - 1, W - 1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speckle_filter_matches_jax_on_random_islands(seed):
    """Blocky random disparities with noise and holes: components of many
    sizes around the window, some kept and some removed."""
    rng = np.random.default_rng(seed)
    H, W = 64, 96
    coarse = rng.integers(0, 4, (H // 8, W // 8)) * 40
    d = np.kron(coarse, np.ones((8, 8), np.int64)).astype(np.int32)
    d += rng.integers(-8, 9, (H, W)).astype(np.int32)
    valid = rng.random((H, W)) > 0.1
    keep = assert_speckle_matches_jax(d, valid, window=60)
    assert 0 < keep.sum() < valid.sum()


def assert_compute_3d_matches_jax(block, p1, p2):
    seq = render_stereo_sequence(n_frames=1, img_size=(160, 120), f=140.0,
                                 baseline=0.5, seed=0)
    dist = np.array([-0.12, 0.03, 0.001, -0.001, 0.0])
    args = (seq["K"], dist, seq["K"], dist, {"R": seq["R"], "T": seq["T"]},
            {"minDisparity": 0, "numDisparities": 32, "blockSize": block,
             "P1": p1, "P2": p2, "disp12MaxDiff": 1, "preFilterCap": 63,
             "uniquenessRatio": 10, "speckleWindowSize": 0,
             "speckleRange": 0}, (160, 120))
    left = np.clip(seq["left"][0], 0, 255).astype(np.uint8)
    right = np.clip(seq["right"][0], 0, 255).astype(np.uint8)
    xyz_j, disp_j, img_j = openvo_tpu.StereoCamera(*args).compute_3d(left,
                                                                    right)
    xyz, disp, img = openvo_tpu_torch.StereoCamera(
        *args, device="cpu").compute_3d(left, right)
    img = img.numpy()
    assert not np.array_equal(img, np.round(img))
    np.testing.assert_array_equal(img, np.asarray(img_j))
    np.testing.assert_array_equal(disp.numpy(), np.asarray(disp_j))
    assert (np.asarray(disp_j) >= 0).mean() > 0.3
    np.testing.assert_allclose(xyz.numpy(), np.asarray(xyz_j), rtol=1e-6)


def test_compute_3d_with_distortion_matches_jax():
    """A camera with a distortion vector: remap gives fractional pixels,
    and the disparity stays bit-equal to JAX's (the bfloat16 cost); the 3D
    image agrees to float32 rounding with the same invalid (inf) set."""
    assert_compute_3d_matches_jax(5, 200, 800)


def test_compute_3d_with_distortion_at_block13_matches_jax():
    """The same camera at blockSize 13, without an int16 sentinel: the
    float32 path on the remapped fractional images gives JAX's disparity."""
    assert_compute_3d_matches_jax(13, 8 * 169, 32 * 169)
