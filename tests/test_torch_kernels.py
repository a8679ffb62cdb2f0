"""Each CUDA kernel of the port against its plain PyTorch version on the
card: bit-equal outputs. Marked ``cuda``: skipped where no card is
present. Run on a machine with one (``--noconftest``: the JAX-free
machine cannot import tests/conftest.py): ``python -m pytest
tests/test_torch_kernels.py -q --noconftest``."""

import dataclasses

import numpy as np
import pytest
import torch

from openvo_tpu_torch.config import SGBMParams
from openvo_tpu_torch.ops import orb_cuda, sgbm, sgbm_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def image_pair(dev, H, W, seed=0, integer=True):
    """A textured pair, right = left shifted by 7 px (by 7.4 px, with every
    pixel fractional, when not ``integer``)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H, W + 40)).astype(np.float32)
    base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 0)) / 3
    if integer:
        right = np.round(base)[:, 27:27 + W]
        base = np.round(base)
    else:
        right = 0.6 * base[:, 27:27 + W] + 0.4 * base[:, 28:28 + W]
    return (torch.from_numpy(base[:, 20:20 + W].copy()).to(dev),
            torch.from_numpy(right.astype(np.float32)).to(dev))


def prefiltered_pair(dev, H, W, seed=0, integer=True, cap=63):
    left, right = image_pair(dev, H, W, seed, integer)
    return sgbm.prefilter_xsobel(left, cap), sgbm.prefilter_xsobel(right, cap)


@pytest.mark.parametrize("H,W,D,block,min_disp,integer", [
    (64, 200, 64, 5, 0, True), (48, 300, 128, 7, 16, True),
    (40, 96, 32, 3, -8, True), (48, 200, 64, 5, 0, False),
    (40, 120, 48, 5, 0, True),      # D not a multiple of 32
    (40, 120, 48, 7, 8, False)])
def test_sgbm_kernels_equal_plain(cuda, H, W, D, block, min_disp, integer):
    lp, rp = prefiltered_pair(cuda, H, W, integer=integer)
    sent = sgbm.int16_sentinel(block, 63)
    args = (min_disp, D, block, sent, 400, 1600, True)
    C, s1 = sgbm_cuda.cost_hsweep(lp, rp, *args)
    Cp, s1p = sgbm_cuda.cost_hsweep_plain(lp, rp, *args)
    assert torch.equal(C, Cp) and torch.equal(s1, s1p)
    sv = sgbm_cuda.vsweep(C, 400, 1600, True)
    assert torch.equal(sv, sgbm_cuda.vsweep_plain(C, 400, 1600, True))
    wta = (400, 1600, min_disp, 10, 1)
    d = sgbm_cuda.hsweep_wta_lr(C, s1, sv, *wta)
    assert torch.equal(d, sgbm_cuda.hsweep_wta_lr_plain(C, s1, sv, *wta))
    torch.cuda.synchronize()


def test_cost_hsweep_float32_costs_equal_plain(cuda):
    """preFilterCap 101 keeps a sentinel at block 5 and takes the float32
    BT arithmetic (2*cap > 127)."""
    lp, rp = prefiltered_pair(cuda, 40, 160, integer=False, cap=101)
    args = (0, 64, 5, sgbm.int16_sentinel(5, 101), 400, 1600, False)
    C, s1 = sgbm_cuda.cost_hsweep(lp, rp, *args)
    Cp, s1p = sgbm_cuda.cost_hsweep_plain(lp, rp, *args)
    assert torch.equal(C, Cp) and torch.equal(s1, s1p)


def int32_cost(dev, H, W, D, block=13):
    lp, rp = prefiltered_pair(dev, H, W)
    return sgbm_cuda.cost_volume(lp, rp, 0, D, block, 8 * 63, True)


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("D", [64, 48])
@pytest.mark.parametrize("diagonals,down,up", [
    (True, True, False), (True, False, True), (True, True, True),
    (False, True, False), (False, False, True), (False, True, True)])
def test_vsweep_variants_equal_plain(cuda, dtype, D, diagonals, down, up):
    C = int32_cost(cuda, 40, 112, D)
    p1, p2 = 2 * 8 * 169, 2 * 32 * 169
    if dtype == torch.int16:
        lp, rp = prefiltered_pair(cuda, 40, 112)
        C, _ = sgbm_cuda.cost_hsweep(lp, rp, 0, D, 5, 504, 400, 1600, True)
        p1, p2 = 400, 1600
    n0 = sgbm_cuda.vsweep.launches
    sv = sgbm_cuda.vsweep(C, p1, p2, diagonals, down, up)
    assert sgbm_cuda.vsweep.launches == n0 + 1
    assert torch.equal(sv, sgbm_cuda.vsweep_plain(C, p1, p2, diagonals, down,
                                                  up))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("D", [64, 48])
def test_hsweep_equal_plain(cuda, reverse, D):
    C = int32_cost(cuda, 40, 112, D)
    p1, p2 = 2 * 8 * 169, 2 * 32 * 169
    L = sgbm_cuda.hsweep(C, p1, p2, reverse)
    assert torch.equal(L, sgbm_cuda.hsweep_plain(C, p1, p2, reverse))
    acc = torch.arange(C.numel(), dtype=torch.int32, device=cuda).view(C.shape)
    assert torch.equal(sgbm_cuda.hsweep(C, p1, p2, reverse, acc), L + acc)


@pytest.mark.parametrize("D,paths", [(64, 5), (64, 8), (48, 4)])
def test_hsweep_wta_lr_int32_equal_plain(cuda, D, paths):
    """H3 over an int32 C, the port of K7, with uniqueness in float32."""
    C = int32_cost(cuda, 48, 160, D)
    p1, p2 = 2 * 8 * 169, 2 * 32 * 169
    s1 = sgbm_cuda.hsweep(C, p1, p2)
    sv = sgbm_cuda.vsweep(C, p1, p2, paths != 4, True, paths != 5)
    wta = (p1, p2, 0, 10, 1)
    d = sgbm_cuda.hsweep_wta_lr(C, s1, sv, *wta)
    assert torch.equal(d, sgbm_cuda.hsweep_wta_lr_plain(C, s1, sv, *wta))


@pytest.mark.parametrize("change", [
    dict(num_paths=4), dict(num_paths=8), dict(num_disparities=48),
    dict(block_size=13, p1=8 * 169, p2=32 * 169), dict(pre_filter_cap=400),
    dict(speckle_window_size=100, speckle_range=2, num_paths=8)])
def test_sgbm_configurations_equal_cpu(cuda, change):
    """The whole SGBM on the card (kernels) equals it on the CPU (plain
    versions) in each configuration, on a fractional pair."""
    p = dataclasses.replace(
        SGBMParams(num_disparities=64, block_size=5, p1=200, p2=800,
                   disp12_max_diff=1, pre_filter_cap=63, uniqueness_ratio=10),
        **change)
    left, right = image_pair(cuda, 64, 200, integer=False)
    out = sgbm.sgbm_disparity16(left, right, p)
    ref = sgbm.sgbm_disparity16(left.cpu(), right.cpu(), p)
    assert torch.equal(out.cpu(), ref)


def test_brief_describe_equals_plain(cuda):
    rng = np.random.default_rng(1)
    K = 512
    wins = torch.from_numpy(np.round(rng.uniform(0, 255, (K, 1521)))
                            .astype(np.float32)).to(cuda)
    ip = torch.from_numpy(rng.integers(0, 1521, (K, 256), dtype=np.int32)
                          ).to(cuda)
    iq = torch.from_numpy(rng.integers(0, 1521, (K, 256), dtype=np.int32)
                          ).to(cuda)
    valid = torch.from_numpy(rng.random(K) > 0.1).to(cuda)
    n0 = orb_cuda.brief_describe.launches
    out = orb_cuda.brief_describe(wins, ip, iq, valid)
    assert orb_cuda.brief_describe.launches == n0 + 1
    assert torch.equal(out, orb_cuda.brief_describe_plain(wins, ip, iq,
                                                          valid))


def test_wrappers_reject_wrong_input(cuda):
    lp, rp = prefiltered_pair(cuda, 16, 64)
    with pytest.raises(TypeError):
        sgbm_cuda.cost_hsweep(lp.double(), rp.double(), 0, 32, 5, 504, 400,
                              1600, True)
    with pytest.raises(ValueError, match="device mismatch"):
        sgbm_cuda.cost_hsweep(lp, rp.cpu(), 0, 32, 5, 504, 400, 1600, True)
    with pytest.raises(ValueError):
        sgbm_cuda.cost_hsweep(lp, rp, 0, 1040, 5, 504, 400, 1600, True)
    C = torch.zeros((16, 64, 32), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        sgbm_cuda.vsweep(C, 400, 1600, True)
    with pytest.raises(TypeError):
        sgbm_cuda.hsweep(C.to(torch.int16), 400, 1600)
