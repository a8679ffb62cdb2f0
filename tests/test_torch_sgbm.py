"""The PyTorch port's SGBM (plain versions of kernels H1-H3) against the JAX
package's CPU path, which is the tier-1 oracle: disparity x16 bit-equal."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from openvo_tpu.config import SGBMParams as JaxSGBMParams
from openvo_tpu.io.synthetic import render_stereo_sequence
from openvo_tpu.ops import sgbm as jsgbm
from openvo_tpu_torch.config import SGBMParams
from openvo_tpu_torch.ops import sgbm, sgbm_cuda


def stereo_pair(H, W, shift=7, seed=0):
    """Integer-valued textured pair: right = left shifted by ``shift`` px."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H, W + 40)).astype(np.float32)
    base = np.round((base + np.roll(base, 1, 1) + np.roll(base, 1, 0)) / 3)
    return (base[:, 20:20 + W].copy(),
            base[:, 20 + shift:20 + shift + W].copy())


def params_kw(D, block, min_disp, uniqueness=10, disp12=1):
    return dict(min_disparity=min_disp, num_disparities=D,
                block_size=block, p1=200, p2=800, disp12_max_diff=disp12,
                pre_filter_cap=63, uniqueness_ratio=uniqueness)


@pytest.mark.parametrize("H,W,D,block,min_disp,uniq,disp12", [
    (160, 256, 64, 5, 0, 10, 1),
    (160, 300, 64, 5, 0, 10, 1),     # width not a multiple of 128
    (160, 256, 64, 7, 16, 10, 1),
    (160, 300, 64, 7, 0, 10, 1),
    (160, 300, 64, 5, 16, 10, 1),
    (96, 128, 32, 5, 0, 0, -1),      # uniqueness and LR check off
])
def test_disp16_bit_equal_to_jax(H, W, D, block, min_disp, uniq, disp12):
    left, right = stereo_pair(H, W, seed=H + W + block)
    kw = params_kw(D, block, min_disp, uniq, disp12)
    ref = np.asarray(jsgbm.sgbm_disparity16(
        jnp.asarray(left), jnp.asarray(right), JaxSGBMParams(**kw)))
    out = sgbm.sgbm_disparity16(torch.from_numpy(left),
                                torch.from_numpy(right), SGBMParams(**kw))
    assert out.dtype == torch.int16
    np.testing.assert_array_equal(out.numpy(), ref)
    # the comparison is not vacuous: most pixels carry a valid disparity
    assert (ref > (min_disp - 1) * 16).mean() > 0.3


@pytest.mark.parametrize("H,W,D,block,min_disp,uniq,disp12", [
    (24, 100, 1, 5, 0, 10, 1),
    (16, 12, 16, 3, 0, 10, 1),       # narrower than the ring's chunk
    (16, 70, 24, 5, -8, 15, 0),
    (24, 100, 31, 5, -8, 10, 1),
    (24, 130, 33, 3, 16, 10, 1),
    (24, 20, 48, 5, 0, 10, 1),       # narrower than a 32-column tile
    (24, 300, 128, 5, 0, 0, -1),
    (16, 300, 128, 7, -8, 15, 0),
    (12, 400, 256, 5, 16, 10, 1),
    (8, 500, 400, 5, 0, 10, 1),
    (8, 1100, 1024, 5, 0, 10, 1),
    (8, 40, 1024, 3, -8, 10, 1),     # narrower than D
])
def test_kernel_edge_shapes_bit_equal_to_jax(H, W, D, block, min_disp, uniq,
                                             disp12):
    """The plain versions of H1-H3 against JAX at the shapes that take the
    CUDA kernels' warp walks to their edges (every number of disparities a
    lane holds, widths that end a column tile early, min_disp -8, 0 and
    16; tests/test_torch_kernels.py holds the kernels to these plain
    versions on the card)."""
    left, right = stereo_pair(H, W, seed=D + W)
    kw = params_kw(16, block, min_disp, uniq, disp12)
    ref = np.asarray(jsgbm.sgbm_disparity16(
        jnp.asarray(left), jnp.asarray(right),
        with_disparities(JaxSGBMParams(**kw), D)))
    out = sgbm.sgbm_disparity16(torch.from_numpy(left),
                                torch.from_numpy(right),
                                with_disparities(SGBMParams(**kw), D))
    np.testing.assert_array_equal(out.numpy(), ref)


def with_disparities(params, D):
    """``params`` with D disparities: SGBMParams takes multiples of 16
    (OpenCV's rule), the SGBM functions and kernels any D in [1, 1024]."""
    object.__setattr__(params, "num_disparities", D)
    return params


def prefiltered(H=48, W=100, seed=3):
    left, right = stereo_pair(H, W, seed=seed)
    lj = jsgbm.prefilter_xsobel(jnp.asarray(left), 63)
    rj = jsgbm.prefilter_xsobel(jnp.asarray(right), 63)
    lt = sgbm.prefilter_xsobel(torch.from_numpy(left), 63)
    rt = sgbm.prefilter_xsobel(torch.from_numpy(right), 63)
    return lj, rj, lt, rt


def test_prefilter_bit_equal():
    lj, rj, lt, rt = prefiltered()
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


@pytest.mark.parametrize("block,min_disp", [(5, 0), (7, 16)])
def test_cost_volume_and_forward_partials(block, min_disp):
    """H1's C equals bt_cost_volume + block_sum; its s1 and H2's sum are
    twice the JAX scans (the port keeps the x2 grid)."""
    D = 32
    lj, rj, lt, rt = prefiltered()
    sent = sgbm.int16_sentinel(block, 63)
    Cj = jsgbm.block_sum(jsgbm.bt_cost_volume(lj, rj, min_disp, D,
                                              block_size=block, cap=63),
                         block)
    C, s1 = sgbm_cuda.cost_hsweep(lt, rt, min_disp, D, block, sent, 400,
                                  1600, True)
    np.testing.assert_array_equal(C.numpy(), np.asarray(Cj))
    s1j = jnp.swapaxes(jsgbm._scan_dirs(jnp.swapaxes(Cj, 0, 1), (0,), 200.0,
                                        800.0, False), 0, 1)
    np.testing.assert_array_equal(s1.numpy(), 2 * np.asarray(s1j))
    svj = jsgbm._scan_dirs(Cj, (0, 1, -1), 200.0, 800.0, False)
    sv = sgbm_cuda.vsweep(C, 400, 1600, diagonals=True)
    np.testing.assert_array_equal(sv.numpy(), 2 * np.asarray(svj))


def shifted_corridor_pair(shift=0.37, img_size=(240, 96)):
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


@pytest.mark.parametrize("num_paths", [5, 8, 4])
def test_float32_forward_and_vertical_partials(num_paths):
    """Without an int16 sentinel (block 13) on the pair shifted by 0.37 px:
    ``cost_and_forward``'s C and H5's forward partial s1, ``vertical``'s
    top-down (and bottom-up) partials and each direction's scan equal JAX's
    float32 ``_scan_dirs`` bit for bit, including the first step from the
    1e9 carry, (c + 1e9) - 1e9."""
    D, block, cap = 32, 13, 63
    kw = dict(params_kw(D, block, 0), p1=8 * 169, p2=32 * 169,
              num_paths=num_paths)
    left, right = shifted_corridor_pair()
    lj = jsgbm.prefilter_xsobel(jnp.asarray(left), cap)
    rj = jsgbm.prefilter_xsobel(jnp.asarray(right), cap)
    lt, rt = torch.tensor(np.asarray(lj)), torch.tensor(np.asarray(rj))
    assert sgbm.int16_sentinel(block, cap) is None
    C, s1, p1, p2 = sgbm.cost_and_forward(lt, rt, SGBMParams(**kw), cap)
    Cj = jsgbm.block_sum(jsgbm.bt_cost_volume(lj, rj, 0, D, block_size=block,
                                              cap=cap), block)
    assert C.dtype == torch.float32 and (p1, p2) == (8 * 169, 32 * 169)
    np.testing.assert_array_equal(C.numpy(), np.asarray(Cj))

    def scan(vol, xshifts, reverse):
        return np.asarray(jsgbm._scan_dirs(vol, xshifts, float(p1),
                                           float(p2), reverse))

    s1j = np.swapaxes(scan(jnp.swapaxes(Cj, 0, 1), (0,), False), 0, 1)
    np.testing.assert_array_equal(s1.numpy(), s1j)
    c0 = np.asarray(Cj)[:, 0]
    first = (c0 + np.float32(1e9)) - np.float32(1e9)
    np.testing.assert_array_equal(s1.numpy()[:, 0], first)
    assert (first != c0).mean() > 0.5     # the carry rounds c
    sv, svu = sgbm.vertical(C, p1, p2, num_paths)
    xshifts = (0,) if num_paths == 4 else (0, 1, -1)
    np.testing.assert_array_equal(sv.numpy(), scan(Cj, xshifts, False))
    if num_paths == 5:
        assert svu is None
    else:
        np.testing.assert_array_equal(svu.numpy(), scan(Cj, xshifts, True))
    for k in xshifts:   # H2 over float32 C walks one direction a launch
        for reverse in (False, True):
            L = sgbm_cuda.scan_f32(C, k, p1, p2, reverse)
            np.testing.assert_array_equal(L.numpy(), scan(Cj, (k,), reverse))


def test_fresh_start_matches_jax_carry_rounding():
    """A scan's first L is (c + 1e9) - 1e9 in float32 in the JAX package:
    c rounded half-to-even to a multiple of 64 (x1 grid), e.g. 37.5 -> 64
    and 6300 -> 6272. The port's x2-grid fresh_start reproduces it."""
    rng = np.random.default_rng(0)
    c2 = rng.integers(0, 12601, (1, 256, 32)).astype(np.int16)
    c2[0, :4, 0] = [75, 12600, 64, 192]   # 37.5 -> 64, 6300 -> 6272, ties
    first = jsgbm._scan_dirs(jnp.asarray(c2), (0,), 200.0, 800.0, False)
    out = sgbm_cuda.fresh_start(torch.from_numpy(c2.astype(np.int32)))
    np.testing.assert_array_equal(out.numpy(), 2 * np.asarray(first))
    assert out[0, 0, 0] == 128 and out[0, 1, 0] == 2 * 6272


def test_sgbm_disparity_is_disp16_over_16():
    left, right = stereo_pair(64, 96)
    p = SGBMParams(**params_kw(32, 5, 0))
    d16 = sgbm.sgbm_disparity16(torch.from_numpy(left),
                                torch.from_numpy(right), p)
    d = sgbm.sgbm_disparity(torch.from_numpy(left), torch.from_numpy(right),
                            p)
    np.testing.assert_array_equal(d.numpy(), d16.numpy() / np.float32(16))


@pytest.mark.parametrize("change", [
    # 5 paths x (25 x 504 + 2 x P2) x 32 disparities passes 2^31
    dict(p2=20_000_000),
])
def test_outside_envelope_raises(change):
    left, right = stereo_pair(32, 64)
    p = SGBMParams(**dict(params_kw(32, 5, 0), **change))
    with pytest.raises(NotImplementedError):
        sgbm.sgbm_disparity16(torch.from_numpy(left),
                              torch.from_numpy(right), p)


def test_cpu_tensors_take_the_plain_version_without_counting():
    lj, rj, lt, rt = prefiltered(24, 48)
    before = [k.launches for k in sgbm_cuda.KERNELS]
    C, s1 = sgbm_cuda.cost_hsweep(lt, rt, 0, 32, 5, 504, 400, 1600, True)
    sgbm_cuda.vsweep(C, 400, 1600, diagonals=True, up=True, acc=s1)
    sgbm_cuda.hsweep_wta_lr(C, s1, None, 400, 1600, 0, 10, 1)
    Cf = sgbm_cuda.cost_volume_f32(lt, rt, 0, 32, 13, 63, True)
    s1f = sgbm_cuda.hsweep(Cf, 200, 800)
    svf = sgbm_cuda.vsweep(Cf, 200, 800, diagonals=True)
    sgbm_cuda.hsweep_wta_lr(Cf, s1f, svf, 200, 800, 0, 10, 1, svu=svf)
    assert [k.launches for k in sgbm_cuda.KERNELS] == before


def test_vsweep_acc_adds_the_int16_sweep_in_place():
    """``acc`` takes H2's sum over int16 C in place (the SGBM adds the
    vertical sweeps into s1, and H3 reads no sv); over float32 C, and for a
    vertical partial handed to H3 over int16 C, the wrappers raise."""
    _, _, lt, rt = prefiltered(24, 48)
    C, s1 = sgbm_cuda.cost_hsweep(lt, rt, 0, 32, 5, 504, 400, 1600, True)
    down = sgbm_cuda.vsweep(C, 400, 1600, True)
    up = sgbm_cuda.vsweep(C, 400, 1600, True, down=False, up=True)
    acc = down.clone()
    out, carry = sgbm_cuda.vsweep(C, 400, 1600, True, down=False, up=True,
                                  acc=acc, return_carry=True)
    assert out is acc and torch.equal(acc, down + up)
    assert torch.equal(carry, sgbm_cuda.vsweep(
        C, 400, 1600, True, down=False, up=True, return_carry=True)[1])
    wta = (400, 1600, 0, 10, 1)
    for sv, svu in [(down, None), (down, up), (None, up)]:
        with pytest.raises(ValueError, match="added into s1"):
            sgbm_cuda.hsweep_wta_lr(C, s1, sv, *wta, svu)
    assert torch.equal(
        sgbm_cuda.hsweep_wta_lr(C, sgbm_cuda.vsweep(C, 400, 1600, True,
                                                     acc=s1.clone()),
                                None, *wta),
        sgbm_cuda.hsweep_wta_lr_plain(C, s1, down, *wta))
    Cf = sgbm_cuda.cost_volume_f32(lt, rt, 0, 32, 13, 63, True)
    with pytest.raises(ValueError, match="int16 C only"):
        sgbm_cuda.vsweep(Cf, 200, 800, True, acc=torch.zeros_like(Cf))
    with pytest.raises(ValueError, match="sum order"):
        sgbm_cuda.hsweep_wta_lr(Cf, Cf, None, 200, 800, 0, 10, 1)


def test_device_mismatch_raises():
    lt = torch.zeros((8, 40))
    with pytest.raises(ValueError, match="device mismatch"):
        sgbm_cuda.cost_hsweep(lt, lt.to("meta"), 0, 32, 5, 504, 400, 1600,
                              True)


# vsweep_design's cases: (C's dtype, diagonals, carry, aligned, D, W,
# frames) -> the kernel it gives. One or two KITTI frames keep the line walk
# and three take the trio walk, as measured on the H100 (TRIO_MIN_FRAMES).
DESIGN_CASES = [
    ("the 5-path trio of a rig", torch.int16, True, False, True, 128, 1241,
     8, "trio"),
    ("a replay chunk", torch.int16, True, False, True, 128, 1241, 16,
     "trio"),
    ("four frames", torch.int16, True, False, True, 64, 320, 4, "trio"),
    ("three frames", torch.int16, True, False, True, 128, 1241, 3, "trio"),
    ("D 8", torch.int16, True, False, True, 8, 30, 4, "trio"),
    ("a single frame", torch.int16, True, False, True, 128, 1241, 1,
     "lines"),
    ("two frames", torch.int16, True, False, True, 128, 1241, 2, "lines"),
    ("float32 C", torch.float32, True, False, True, 128, 1241, 8, "lines"),
    ("the straight line alone", torch.int16, False, False, True, 128, 1241,
     8, "lines"),
    ("a carry", torch.int16, True, True, True, 128, 1241, 8, "lines"),
    ("an unaligned volume", torch.int16, True, False, False, 128, 1241, 8,
     "lines"),
    ("D not a multiple of 8", torch.int16, True, False, True, 36, 1241, 8,
     "lines"),
    ("D beyond 128", torch.int16, True, False, True, 136, 1241, 8, "lines"),
    ("D 256", torch.int16, True, False, True, 256, 1241, 8, "lines"),
    ("wider than TRIO_MAX_W", torch.int16, True, False, True, 128,
     sgbm_cuda.TRIO_MAX_W + 1, 8, "lines"),
]


@pytest.mark.parametrize("case", DESIGN_CASES,
                         ids=[c[0] for c in DESIGN_CASES])
def test_vsweep_design_takes_the_trio_walk_only_where_it_may(case):
    """H2's choice between the trio walk and the line walk, a pure function
    of what the call shows: the trio walk for a batch of the int16 trio
    with aligned volumes and D a multiple of 8 up to 128; the line walk for
    float32 C, the straight line alone, a carry, an unaligned volume, any
    other D or width, and one or two frames."""
    *args, want = case[1:]
    assert sgbm_cuda.vsweep_design(*args) == want
