"""Each CUDA kernel of the port against its plain PyTorch version on the
card: bit-equal outputs. Marked ``cuda``: skipped where no card is
present. Run on a machine with one (``--noconftest``: the JAX-free
machine cannot import tests/conftest.py): ``python -m pytest
tests/test_torch_kernels.py -q --noconftest``."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from openvo_tpu_torch import trace
from openvo_tpu_torch.config import SGBMParams
from openvo_tpu_torch.ops import (clique_cuda, jacobi_cuda, orb_cuda, sgbm,
                                  sgbm_cuda, speckle_cuda)
from openvo_tpu_torch.pose import kabsch
from openvo_tpu_torch.tools import loop_cases, svd_cases

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
    # as the SGBM runs them: H2 adds into s1, H3 reads no sv
    folded = sgbm_cuda.vsweep(C, 400, 1600, True, acc=s1.clone())
    assert torch.equal(folded, s1 + sv)
    wta = (400, 1600, min_disp, 10, 1)
    d = sgbm_cuda.hsweep_wta_lr(C, folded, None, *wta)
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


def f32_cost(dev, H, W, D, block=13):
    """The float32 cost of a configuration without an int16 sentinel, on a
    fractional pair."""
    lp, rp = prefiltered_pair(dev, H, W, integer=False)
    return sgbm_cuda.cost_volume_f32(lp, rp, 0, D, block, 63, True)


def int16_cost(dev, H, W, D):
    lp, rp = prefiltered_pair(dev, H, W)
    return sgbm_cuda.cost_hsweep(lp, rp, 0, D, 5, 504, 400, 1600, True)[0]


def cost_and_penalties(dev, dtype, H, W, D):
    if dtype == torch.int16:
        return int16_cost(dev, H, W, D), 400, 1600
    return f32_cost(dev, H, W, D), 8 * 169, 32 * 169


def shifted(t):
    """The same values one element into a new buffer: a contiguous view
    that does not start on 16 bytes."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


def walk_cost(dev, dtype, H, W, D):
    """(C, p1, p2) for H2's and H5's cases: a textured pair's cost at the
    first shape, random costs (fractional over float32) elsewhere."""
    if (H, W) == (40, 112):
        return cost_and_penalties(dev, dtype, H, W, D)
    rng = np.random.default_rng(H * W + D)
    c = rng.integers(0, 4000, (H, W, D))
    if dtype == torch.int16:
        return torch.from_numpy(c.astype(np.int16)).to(dev), 400, 1600
    c = (c + rng.random((H, W, D))).astype(np.float32)
    return torch.from_numpy(c).to(dev), 8 * 169, 32 * 169


# (H, W, D) of H2's and H5's cases: every lane width of the warp walks'
# fast feeds (D = 16: 1 disparity a lane; 48: 2; 64: 2; 128: 4; 256: 8)
# and of their scalar feed (D = 1, 33, 1024: 32 a lane), H > W (diagonals
# leave by the side), W = 1, H = 1, and W below the ring's 16-column chunk
WALK_SHAPES = [(40, 112, 64), (40, 112, 48), (24, 70, 1), (24, 70, 16),
               (24, 70, 33), (16, 90, 128), (12, 300, 256), (6, 40, 1024),
               (70, 24, 48), (30, 1, 48), (1, 30, 48), (16, 12, 16)]
# H2's cases: each shape as a whole volume; a few as a view that does not
# start on 16 bytes (the scalar feed at a D the fast one takes), over int16
# C adding into a given partial sum (acc), and as a batch of 2 to 5 frames
# of other costs (where vsweep_design takes it, the trio walk: H > W,
# W = 1, H = 1, and D at the edges of what the walk takes, 8 and 128, and
# beyond them, 33 and 256; 2 frames, fewer than it takes)
VSWEEP_CASES = (
    [(dt, s, "whole") for dt in (torch.int16, torch.float32)
     for s in WALK_SHAPES]
    + [(dt, s, "unaligned") for dt in (torch.int16, torch.float32)
       for s in [(40, 112, 64), (16, 90, 128), (70, 24, 48)]]
    + [(torch.int16, s, "acc") for s in [(40, 112, 64), (24, 70, 33),
                                          (70, 24, 48)]]
    + [(torch.int16, s, f"batch{b}") for s, b in [
        ((40, 112, 64), 4), ((70, 24, 48), 5), ((30, 1, 48), 4),
        ((1, 30, 48), 5), ((24, 70, 8), 4), ((16, 90, 128), 5),
        ((24, 70, 33), 4), ((12, 300, 256), 4), ((12, 900, 16), 4),
        ((40, 112, 64), 2)]])


def case_id(case):
    return "-".join(str(v).replace("torch.", "") for v in case)


def batch_walk_cost(C, frames):
    """C and frames - 1 random int16 costs of its shape after it."""
    rng = np.random.default_rng(frames)
    rest = rng.integers(0, 4000, (frames - 1,) + tuple(C.shape))
    return torch.cat([C[None], torch.from_numpy(rest.astype(np.int16)).to(
        C.device)])


def design_counts():
    """{trace counter: its total} of the records since the last clear:
    the H2 launches of each design."""
    out = {"ovo.vsweep": 0, "ovo.vsweep_trio": 0}
    for r in trace.records():
        if r.name in out:
            out[r.name] += r.n
    return out


@pytest.fixture
def traced():
    trace.clear()
    trace.enable()
    yield
    trace.disable()
    trace.clear()


@pytest.mark.parametrize("dtype,shape,view", VSWEEP_CASES,
                         ids=[case_id(c) for c in VSWEEP_CASES])
@pytest.mark.parametrize("diagonals,down,up", [
    (True, True, False), (True, False, True), (True, True, True),
    (False, True, False), (False, False, True), (False, True, True)])
def test_vsweep_variants_equal_plain(cuda, traced, dtype, shape, view,
                                     diagonals, down, up):
    """H2 over int16 C (the trio walk, one launch a direction of travel,
    where vsweep_design takes it, else one launch for every line) and over
    float32 C (one launch per direction, one direction of travel a call),
    at every lane width, on unaligned views, over int16 C adding into
    ``acc`` and on batches; the trace counters name the kernel each launch
    took."""
    C, p1, p2 = walk_cost(cuda, dtype, *shape)
    if view.startswith("batch"):
        C = batch_walk_cost(C, int(view[5:]))
    if dtype == torch.float32 and down and up:
        with pytest.raises(ValueError):
            sgbm_cuda.vsweep(C, p1, p2, diagonals, down, up)
        return
    ref = sgbm_cuda.vsweep_plain(C, p1, p2, diagonals, down, up)
    acc = None
    if view == "unaligned":
        C = shifted(C)
    elif view == "acc":
        acc = torch.from_numpy(np.random.default_rng(1).integers(
            0, 1 << 20, tuple(C.shape), dtype=np.int32)).to(cuda)
        ref = ref + acc
    design = sgbm_cuda.vsweep_design(
        dtype, diagonals, False, view != "unaligned", shape[2], shape[1],
        C.shape[0] if C.ndim == 4 else 1)
    n0 = sgbm_cuda.vsweep.launches
    sv = sgbm_cuda.vsweep(C, p1, p2, diagonals, down, up, acc=acc)
    launches = (down + up if design == "trio" else
                3 if dtype == torch.float32 and diagonals else 1)
    assert sgbm_cuda.vsweep.launches == n0 + launches
    assert design_counts() == {
        "ovo.vsweep": 0 if design == "trio" else launches,
        "ovo.vsweep_trio": launches if design == "trio" else 0}
    assert acc is None or sv is acc
    assert torch.equal(sv, ref)


# The trio walk called directly (a single frame too, which vsweep gives to
# the line walk), at KITTI's size in 1, 8 and 16 frames (the cells' batches)
# and on small shapes that cut the strips otherwise: each direction of
# travel, into a random partial sum (as into H1's s1)
TRIO_CASES = [(1, 376, 1242, 128, "down"), (8, 376, 1242, 128, "down"),
              (16, 376, 1242, 128, "down"), (1, 376, 1241, 128, "up"),
              (8, 376, 1241, 128, "up"), (2, 376, 1242, 128, "both"),
              (1, 70, 24, 48, "both"), (2, 30, 1, 48, "up"),
              (1, 1, 30, 48, "down"), (3, 24, 70, 8, "both"),
              (2, 16, 90, 16, "up"), (5, 40, 337, 128, "down")]


@pytest.mark.parametrize("B,H,W,D,way", TRIO_CASES,
                         ids=["-".join(map(str, c)) for c in TRIO_CASES])
def test_vsweep_trio_equals_plain_and_lines(cuda, B, H, W, D, way):
    """The trio walk into a partial sum equals the plain version's sum and
    the line walk's (today's H2 for the other variants), bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(B * H * W + D)
    C = torch.randint(0, 4000, (B, H, W, D), generator=g, device=cuda,
                      dtype=torch.int16)
    base = torch.randint(0, 1 << 20, (B, H, W, D), generator=g, device=cuda,
                         dtype=torch.int32)
    down, up = way != "up", way != "down"
    if B == 1:
        C, base = C[0], base[0]
    trio = sgbm_cuda._vsweep_trio(C, base.clone(), 400, 1600, down, up)
    lines = sgbm_cuda._vsweep_lines(C, base.clone(), 400, 1600, 3, down, up)
    assert torch.equal(trio, lines)
    assert torch.equal(trio, base + sgbm_cuda.vsweep_plain(
        C, 400, 1600, True, down, up))
    torch.cuda.synchronize()


@pytest.mark.parametrize("call", ["trio", "single frame", "unaligned",
                                  "carry", "straight", "float32"])
def test_vsweep_design_takes_the_line_walk_where_it_must(cuda, traced, call):
    """A batch of the int16 trio takes the trio walk; an unaligned view, a
    carry, the straight line alone and float32 C keep the line walk, as
    does a single frame; both equal the plain version."""
    B = 1 if call == "single frame" else 4
    dtype = torch.float32 if call == "float32" else torch.int16
    C, p1, p2 = walk_cost(cuda, dtype, 40, 112, 64)
    C = torch.stack([C] * B) if B > 1 else C
    diagonals = call != "straight"
    ref = sgbm_cuda.vsweep_plain(C, p1, p2, diagonals)
    if call == "carry":
        out = sgbm_cuda.vsweep(C, p1, p2, diagonals, return_carry=True)[0]
    else:
        out = sgbm_cuda.vsweep(shifted(C) if call == "unaligned" else C, p1,
                               p2, diagonals)
    assert torch.equal(out, ref)
    trio = call == "trio"
    lines = 3 if call == "float32" else 1
    assert design_counts() == {"ovo.vsweep": 0 if trio else lines,
                               "ovo.vsweep_trio": 1 if trio else 0}


# (H, W, D, split row) of the carry cases
CARRY_SHAPES = [(48, 112, 64, 20), (24, 70, 33, 9), (16, 90, 128, 5),
                (12, 300, 256, 4), (6, 40, 1024, 2), (70, 24, 48, 25),
                (30, 1, 48, 11), (2, 30, 48, 1)]
CARRY_CASES = (
    [(dt, s, "whole") for dt in (torch.int16, torch.float32)
     for s in CARRY_SHAPES]
    + [(dt, (48, 112, 64, 20), "unaligned")
       for dt in (torch.int16, torch.float32)]
    + [(torch.int16, s, "acc") for s in [(48, 112, 64, 20),
                                          (70, 24, 48, 25)]])


@pytest.mark.parametrize("dtype,shape,view", CARRY_CASES,
                         ids=[case_id(c) for c in CARRY_CASES])
@pytest.mark.parametrize("diagonals", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_vsweep_carry_equals_plain(cuda, dtype, shape, view, diagonals,
                                   reverse):
    """H2 with K2's carry in and out, split at a row: each part equals the
    plain version's, the carries are equal, and the joined parts equal the
    unsplit sweep; also on unaligned views and, over int16 C, adding into
    ``acc`` as the row tiles add their bottom-up sweep."""
    H, W, D, split = shape
    C, p1, p2 = (cost_and_penalties(cuda, dtype, H, W, D) if H == 48
                 else walk_cost(cuda, dtype, H, W, D))
    ways = dict(down=not reverse, up=reverse)
    first, second = (C[split:], C[:split]) if reverse else (C[:split],
                                                             C[split:])
    a_p, carry_p = sgbm_cuda.vsweep_plain(first, p1, p2, diagonals, **ways,
                                          return_carry=True)
    b_p, carry2_p = sgbm_cuda.vsweep_plain(second, p1, p2, diagonals, **ways,
                                           init_carry=carry_p,
                                           return_carry=True)
    acc_a = acc_b = None
    if view == "unaligned":
        first, second = shifted(first), shifted(second)
    elif view == "acc":
        rng = np.random.default_rng(2)
        acc_a, acc_b = (torch.from_numpy(rng.integers(
            0, 1 << 20, tuple(t.shape), dtype=np.int32)).to(cuda)
            for t in (first, second))
        a_p, b_p = a_p + acc_a, b_p + acc_b
    a, carry = sgbm_cuda.vsweep(first, p1, p2, diagonals, **ways,
                                return_carry=True, acc=acc_a)
    assert torch.equal(a, a_p) and torch.equal(carry, carry_p)
    b, carry2 = sgbm_cuda.vsweep(second, p1, p2, diagonals, **ways,
                                 init_carry=carry, return_carry=True,
                                 acc=acc_b)
    assert torch.equal(b, b_p) and torch.equal(carry2, carry2_p)
    if view == "whole":
        joined = torch.cat([b, a]) if reverse else torch.cat([a, b])
        assert torch.equal(joined, sgbm_cuda.vsweep(C, p1, p2, diagonals,
                                                    **ways))


@pytest.mark.parametrize("where", ["top", "interior", "bottom"])
def test_cost_hsweep_band_equals_plain(cuda, where):
    """H1 on a row band with halo rows (K1's band_halo) equals its plain
    version and the band's rows of the whole image's H1."""
    lp, rp = prefiltered_pair(cuda, 64, 160)
    halo, h_t = 3, 16
    r0 = {"top": 0, "interior": 24, "bottom": 64 - h_t}[where]
    rows = torch.arange(r0 - halo, r0 + h_t + halo, device=cuda).clamp(0, 63)
    band = (halo, where == "top", where == "bottom")
    args = (0, 64, 5, 504, 400, 1600, True)
    C, s1 = sgbm_cuda.cost_hsweep(lp[rows], rp[rows], *args, band)
    Cp, s1p = sgbm_cuda.cost_hsweep_plain(lp[rows], rp[rows], *args, band)
    assert torch.equal(C, Cp) and torch.equal(s1, s1p)
    Cw, s1w = sgbm_cuda.cost_hsweep(lp, rp, *args)
    assert torch.equal(C, Cw[r0:r0 + h_t])
    assert torch.equal(s1, s1w[r0:r0 + h_t])


# (H, W, D, min_disp, block, integer pair, preFilterCap): every lane width
# of the warp walks' fast feeds (H1's TMA ring, H3's vector loads: D = 16,
# 24: 1 disparity a lane; 48: 2; 128: 4; 256: 8) and of their scalar feed
# (D = 1, 31, 33, 400, 1024: 32 a lane), widths not a multiple of bt_box's
# 32-column tile or of the ring's chunk, and below both, min_disp -8, 0 and
# 16, the bfloat16 cost (cap 63) and the float32 one (cap 101)
EDGES = [
    (16, 100, 1, 0, 5, True, 63),
    (8, 12, 16, 0, 3, True, 63),
    (8, 70, 24, -8, 5, False, 63),
    (16, 100, 31, -8, 5, True, 63),
    (16, 130, 33, 16, 3, False, 63),
    (16, 20, 48, 0, 5, True, 63),
    (24, 300, 128, 0, 5, False, 63),
    (16, 300, 128, -8, 7, False, 101),
    (12, 400, 256, 16, 5, True, 63),
    (8, 500, 400, 0, 5, True, 63),
    (8, 1100, 1024, 0, 5, True, 63),
    (8, 40, 1024, -8, 3, True, 63),
]


@pytest.mark.parametrize("H,W,D,min_disp,block,integer,cap", EDGES)
def test_warp_walks_equal_plain_at_edges(cuda, H, W, D, min_disp, block,
                                         integer, cap):
    """H1 (bt_box + the warp walk) and H3 over int16 C at the shapes where
    the tiles and the lanes' slots end, with uniqueness and the LR check on
    and off."""
    lp, rp = prefiltered_pair(cuda, H, W, integer=integer, cap=cap)
    args = (min_disp, D, block, sgbm.int16_sentinel(block, cap), 400, 1600,
            2 * cap <= 127)
    C, s1 = sgbm_cuda.cost_hsweep(lp, rp, *args)
    Cp, s1p = sgbm_cuda.cost_hsweep_plain(lp, rp, *args)
    assert torch.equal(C, Cp) and torch.equal(s1, s1p)
    sv = sgbm_cuda.vsweep_plain(C, 400, 1600, True)
    for uniq, disp12 in [(10, 1), (0, -1), (15, 0)]:
        wta = (400, 1600, min_disp, uniq, disp12)
        d = sgbm_cuda.hsweep_wta_lr(C, s1 + sv, None, *wta)
        assert torch.equal(d, sgbm_cuda.hsweep_wta_lr_plain(C, s1, sv, *wta))
    torch.cuda.synchronize()


def test_hsweep_wta_lr_int16_with_bottom_up_partial_equals_plain(cuda):
    """Over int16 C, H2 adds both vertical sums into s1 (``acc``, exact in
    any order, as the row tiles do) and H3 walks without them: equal to the
    plain H3 with the partials apart."""
    C = int16_cost(cuda, 24, 150, 48)
    s1 = sgbm_cuda.sgm_scan(C.transpose(0, 1), 0, 400, 1600).transpose(
        0, 1).contiguous()
    sv = sgbm_cuda.vsweep_plain(C, 400, 1600, True)
    svu = sgbm_cuda.vsweep_plain(C, 400, 1600, True, down=False, up=True)
    both = sgbm_cuda.vsweep(C, 400, 1600, True, down=False, up=True,
                            acc=s1 + sv)
    assert torch.equal(both, s1 + sv + svu)
    wta = (400, 1600, 0, 10, 1)
    d = sgbm_cuda.hsweep_wta_lr(C, both, None, *wta)
    assert torch.equal(d, sgbm_cuda.hsweep_wta_lr_plain(C, s1, sv, *wta, svu))


@pytest.mark.parametrize("D", [128, 48])
def test_hsweep_wta_lr_unaligned_volumes_equal_plain(cuda, D):
    """Volumes that do not start on 16 bytes take the scalar loads at a D
    where H3 takes vector loads (int16 C) or the ring (float32 C): equal to
    the plain version."""
    def shifted(t):   # the same values, one element into a new buffer
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    for C, p1, p2 in [(int16_cost(cuda, 16, 90, D), 400, 1600),
                      (f32_cost(cuda, 8, 90, D), 8 * 169, 32 * 169)]:
        s1 = (sgbm_cuda.hsweep_plain(C, p1, p2) if C.is_floating_point() else
              sgbm_cuda.sgm_scan(C.transpose(0, 1), 0, p1, p2).transpose(
                  0, 1).contiguous())
        sv = sgbm_cuda.vsweep_plain(C, p1, p2, True)
        wta = (p1, p2, 0, 10, 1)
        if C.is_floating_point():
            d = sgbm_cuda.hsweep_wta_lr(shifted(C), shifted(s1), sv, *wta)
        else:   # the vertical sum in s1
            d = sgbm_cuda.hsweep_wta_lr(shifted(C), shifted(s1 + sv), None,
                                        *wta)
        assert torch.equal(d, sgbm_cuda.hsweep_wta_lr_plain(C, s1, sv, *wta))


@pytest.mark.parametrize("D", [1, 16, 33, 48, 128, 256, 1024])
@pytest.mark.parametrize("with_svu", [False, True])
def test_hsweep_wta_lr_float32_edges_equal_plain(cuda, D, with_svu):
    """H3 over float32 C (K7) at every lane width, fed by the ring (D = 16,
    48, 128, 256; at D = 16 a width below the ring's chunk) or scalar
    loads, with the bottom-up partial apart and without it, uniqueness and
    the LR check on and off."""
    W = {16: 12}.get(D, D + 76 if D > 128 else 100)
    C = f32_cost(cuda, 8, W, D)
    p1, p2 = 8 * 169, 32 * 169
    s1 = sgbm_cuda.hsweep_plain(C, p1, p2)
    sv = sgbm_cuda.vsweep_plain(C, p1, p2, True)
    svu = (sgbm_cuda.vsweep_plain(C, p1, p2, True, down=False, up=True)
           if with_svu else None)
    for uniq, disp12 in [(10, 1), (0, -1)]:
        wta = (p1, p2, 0, uniq, disp12)
        d = sgbm_cuda.hsweep_wta_lr(C, s1, sv, *wta, svu)
        assert torch.equal(d, sgbm_cuda.hsweep_wta_lr_plain(C, s1, sv, *wta,
                                                            svu))


@pytest.mark.parametrize("where", ["top", "interior", "bottom"])
@pytest.mark.parametrize("D,W,min_disp", [(33, 100, -8), (128, 70, 16)])
def test_cost_hsweep_band_edges_equal_plain(cuda, where, D, W, min_disp):
    """H1 on a row band at other lane widths and tile ends: equal to its
    plain version and to the band's rows of the whole image's H1."""
    lp, rp = prefiltered_pair(cuda, 40, W)
    halo, h_t = 3, 10
    r0 = {"top": 0, "interior": 17, "bottom": 40 - h_t}[where]
    rows = torch.arange(r0 - halo, r0 + h_t + halo, device=cuda).clamp(0, 39)
    band = (halo, where == "top", where == "bottom")
    args = (min_disp, D, 5, 504, 400, 1600, True)
    C, s1 = sgbm_cuda.cost_hsweep(lp[rows], rp[rows], *args, band)
    Cp, s1p = sgbm_cuda.cost_hsweep_plain(lp[rows], rp[rows], *args, band)
    assert torch.equal(C, Cp) and torch.equal(s1, s1p)
    Cw, s1w = sgbm_cuda.cost_hsweep(lp, rp, *args)
    assert torch.equal(C, Cw[r0:r0 + h_t])
    assert torch.equal(s1, s1w[r0:r0 + h_t])


HSWEEP_CASES = ([(s, "whole") for s in WALK_SHAPES]
                + [(s, "unaligned") for s in [(40, 112, 64), (16, 90, 128)]])


@pytest.mark.parametrize("shape,view", HSWEEP_CASES,
                         ids=[case_id(c) for c in HSWEEP_CASES])
def test_hsweep_equal_plain(cuda, shape, view):
    """H5 over float32 C (hwalk over F32: the ring at D a multiple of 8 up
    to 256, else scalar loads), from a previous L of 1e9, at every lane
    width and on unaligned views."""
    C, p1, p2 = walk_cost(cuda, torch.float32, *shape)
    ref = sgbm_cuda.hsweep_plain(C, p1, p2)
    if view == "unaligned":
        C = shifted(C)
    n0 = sgbm_cuda.hsweep.launches
    L = sgbm_cuda.hsweep(C, p1, p2)
    assert sgbm_cuda.hsweep.launches == n0 + 1
    assert torch.equal(L, ref)


@pytest.mark.parametrize("D,paths", [(64, 5), (64, 8), (48, 4)])
def test_hsweep_wta_lr_float32_equal_plain(cuda, D, paths):
    """H3 over float32 C (the port of K7), with the bottom-up partial kept
    apart for 4 and 8 paths."""
    C = f32_cost(cuda, 48, 160, D)
    p1, p2 = 8 * 169, 32 * 169
    s1 = sgbm_cuda.hsweep(C, p1, p2)
    sv, svu = sgbm.vertical(C, p1, p2, paths)
    wta = (p1, p2, 0, 10, 1)
    d = sgbm_cuda.hsweep_wta_lr(C, s1, sv, *wta, svu)
    assert torch.equal(d, sgbm_cuda.hsweep_wta_lr_plain(C, s1, sv, *wta, svu))


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


def brief_inputs(dev, K, integer, nl=8, H=96, W=160, seed=1):
    """H4's inputs on a random (nl, H, W) stack: integer or non-integer
    pixels (a resized level's), keypoints at and beyond every edge where
    the window start is clamped, on every level and on levels out of range,
    then random rows; a fifth of the rows invalid; random angles."""
    rng = np.random.default_rng(seed)
    stack = rng.uniform(0, 255, (nl, H, W)).astype(np.float32)
    if integer:
        stack = np.round(stack)
    ex = [-3, 0, 21, 22, 23, W // 2, W - 23, W - 22, W - 1, W + 4]
    ey = [-3, 0, 21, 22, 23, H // 2, H - 23, H - 22, H - 1, H + 4]
    lv, y, x = (a.reshape(-1) for a in np.meshgrid(
        np.arange(-1, nl + 1), ey, ex, indexing="ij"))
    n = max(K - len(lv), 0)
    lv = np.r_[lv, rng.integers(0, nl, n)][:K]
    y = np.r_[y, rng.integers(22, H - 22, n)][:K]
    x = np.r_[x, rng.integers(22, W - 22, n)][:K]
    ang = torch.from_numpy(rng.uniform(-np.pi, np.pi, K).astype(np.float32))
    valid = rng.random(K) > 0.2
    return tuple(t.to(dev) for t in (
        torch.from_numpy(stack), torch.from_numpy(lv.astype(np.int64)),
        torch.from_numpy(np.stack([x, y], 1).astype(np.int64)),
        torch.cos(ang), torch.sin(ang), torch.from_numpy(valid)))


@pytest.mark.parametrize("K", [0, 1, 7, 512, 1200])
@pytest.mark.parametrize("integer", [True, False])
def test_brief_describe_equals_plain(cuda, K, integer):
    """H4 from the stack to the packed descriptor equals its plain version
    bit for bit (1200 rows hold every edge on every level), and launches
    once (not at all for K = 0)."""
    args = brief_inputs(cuda, K, integer)
    n0 = orb_cuda.brief_describe.launches
    out = orb_cuda.brief_describe(*args)
    assert orb_cuda.brief_describe.launches == n0 + (K > 0)
    ref = orb_cuda.brief_describe_plain(*args)
    assert out.shape == (K, 32) and out.dtype == torch.uint8
    assert torch.equal(out, ref)
    assert not out[~args[5]].any()


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
        sgbm_cuda.vsweep(C.double(), 400, 1600, True)
    with pytest.raises(ValueError):
        sgbm_cuda.vsweep(C, 400, 1600, True, down=True, up=True)
    with pytest.raises(TypeError):
        sgbm_cuda.vsweep(C, 400, 1600, True,
                         init_carry=torch.zeros((3, 64, 32), device=cuda,
                                                dtype=torch.int32))
    with pytest.raises(TypeError):
        sgbm_cuda.hsweep(C.to(torch.int16), 400, 1600)
    with pytest.raises(ValueError, match="sum order"):
        sgbm_cuda.hsweep_wta_lr(C, C, None, 400, 1600, 0, 10, 1)
    S = torch.zeros((16, 64, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="added into s1"):
        sgbm_cuda.hsweep_wta_lr(C.to(torch.int16), S, S, 400, 1600, 0, 10, 1)
    stack, octv, xy, ca, sa, valid = brief_inputs(cuda, 16, True)
    with pytest.raises(TypeError):
        orb_cuda.brief_describe(stack.double(), octv, xy, ca, sa, valid)
    with pytest.raises(TypeError):
        orb_cuda.brief_describe(stack, octv.int(), xy, ca, sa, valid)
    with pytest.raises(TypeError):
        orb_cuda.brief_describe(stack, octv, xy.int(), ca, sa, valid)
    with pytest.raises(ValueError):
        orb_cuda.brief_describe(stack, octv, xy[:, :1].contiguous(), ca, sa,
                                valid)
    with pytest.raises(ValueError, match="contiguous"):
        orb_cuda.brief_describe(stack.transpose(1, 2), octv, xy, ca, sa,
                                valid)
    with pytest.raises(ValueError, match="device mismatch"):
        orb_cuda.brief_describe(stack, octv, xy, ca.cpu(), sa, valid)
    with pytest.raises(ValueError, match="smaller than"):
        orb_cuda.brief_describe(stack[:, :40].contiguous(), octv, xy, ca, sa,
                                valid)


def test_mono_odometer_on_the_card_equals_cpu(cuda):
    """MonoOdometer over 5 frames of the 320x240 corridor on the card and
    on the CPU with the same uniforms: on the card eagerly
    (``_graph.disable_capture()``), H4 launches once a frame, and as users
    run it, each update one replayed CUDA graph, equal to the eager run bit
    for bit; the accept and skip codes, keypoint and match counts equal to
    the CPU's; each frame's motion within 5e-3 rad and its direction within
    0.1 rad (the card's SVD is H11, with JAX's LAPACK basis of the
    five-point null space, the CPU's torch's LAPACK, as
    tests/test_torch_mono.py explains for JAX's)."""
    from openvo_tpu_torch import _graph
    from openvo_tpu_torch.io.synthetic import render_stereo_sequence
    from openvo_tpu_torch.models.mono_odometer import (MonoOdometer,
                                                       ransac_samples)

    seq = render_stereo_sequence(n_frames=5, img_size=(320, 240), f=280.0,
                                 baseline=0.5, seed=0, step=0.3,
                                 yaw_rate=0.004)
    gen = torch.Generator().manual_seed(3)
    us = [torch.rand((ransac_samples(256), 5), generator=gen)
          for _ in range(5)]
    runs = []
    for dev, captured in ((cuda, False), (cuda, True),
                          (torch.device("cpu"), False)):
        odo = MonoOdometer(seq["K"], nfeatures=300, device=dev)
        n0 = orb_cuda.brief_describe.launches
        run = []
        with contextlib.nullcontext() if captured else \
                _graph.disable_capture():
            for i in range(5):
                img = np.clip(seq["left"][i], 0, 255).astype(np.uint8)
                ok = odo.update(img, trans_scale=0.3, u=us[i])
                assert odo.captured == captured
                run.append((ok, dict(odo.last_stats), odo.current_pose()))
        if dev.type == "cuda" and not captured:
            assert orb_cuda.brief_describe.launches == n0 + 5
        runs.append(run)
    eager, replayed, cpu = runs
    for e, r in zip(eager, replayed):
        assert e[0] == r[0] and np.array_equal(e[2], r[2])
        assert all(np.array_equal(e[1][k], r[1][k]) for k in e[1])
    prev = (np.eye(4), np.eye(4))
    for i, (g, w) in enumerate(zip(eager, cpu)):
        assert g[0] == w[0] and w[0]
        for k in ("skip_code", "n_kps", "n_matches"):
            assert int(g[1][k]) == int(w[1][k]), (i, k)
        mg, mw = (np.linalg.inv(p) @ c for p, c in zip(prev, (g[2], w[2])))
        rot = np.arccos(np.clip((np.trace(mg[:3, :3].T @ mw[:3, :3]) - 1)
                                / 2, -1, 1))
        cd = mg[:3, 3] @ mw[:3, 3] / max(
            np.linalg.norm(mg[:3, 3]) * np.linalg.norm(mw[:3, 3]), 1e-12)
        assert rot < 5e-3 and (i == 0 or np.arccos(min(cd, 1.0)) < 0.1), i
        prev = (g[2], w[2])


# ---------------------------------------------------------------------------
# a batch of frames: one launch, each frame's bits
# ---------------------------------------------------------------------------

FRAMES = 3


def batch_pair(dev, H, W, cap=63):
    """FRAMES prefiltered pairs, (FRAMES, H, W) each: two integer pairs of
    other textures and one fractional."""
    pairs = [prefiltered_pair(dev, H, W, seed=s, integer=s != 1, cap=cap)
             for s in range(FRAMES)]
    return tuple(torch.stack(t) for t in zip(*pairs))


def launches(kernel, fn):
    """(fn()'s output, the launches of ``kernel`` it made)."""
    n0 = kernel.launches
    out = fn()
    return out, kernel.launches - n0


def assert_batch(out, frames, plain):
    """``out`` (a tensor or tuple of tensors with a frame axis) equals the
    stacked single-frame outputs ``frames`` and the plain version's."""
    out, plain = as_tuple(out), as_tuple(plain)
    for i, one in enumerate(frames):
        for a, b in zip(out, as_tuple(one), strict=True):
            assert torch.equal(a[i], b), i
    for a, b in zip(out, plain, strict=True):
        assert torch.equal(a, b)


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("H,W,D,band", [
    (40, 120, 64, None), (48, 200, 128, None), (40, 100, 33, None),
    (40, 120, 48, (3, False, False)), (40, 120, 64, (3, True, False))])
def test_batched_cost_hsweep_equals_frames(cuda, H, W, D, band):
    lp, rp = batch_pair(cuda, H, W)
    args = (0, D, 5, sgbm.int16_sentinel(5, 63), 400, 1600, True, band)
    out, n = launches(sgbm_cuda.cost_hsweep,
                      lambda: sgbm_cuda.cost_hsweep(lp, rp, *args))
    assert n == 1
    assert_batch(out, [sgbm_cuda.cost_hsweep(lp[i], rp[i], *args)
                       for i in range(FRAMES)],
                 sgbm_cuda.cost_hsweep_plain(lp, rp, *args))


def batch_cost(dev, dtype, H, W, D):
    """(C (FRAMES, H, W, D), p1, p2) of FRAMES pairs."""
    lp, rp = batch_pair(dev, H, W)
    if dtype == torch.int16:
        return sgbm_cuda.cost_hsweep(lp, rp, 0, D, 5, 504, 400, 1600,
                                     True)[0], 400, 1600
    return (sgbm_cuda.cost_volume_f32(lp, rp, 0, D, 13, 63, True), 8 * 169,
            32 * 169)


# (C's dtype, diagonals, down, up): every variant a path runs (float32 C
# takes one direction of travel a call)
BATCHED_VSWEEP = [(torch.int16, True, True, False),
                  (torch.int16, True, False, True),
                  (torch.int16, True, True, True),
                  (torch.int16, False, True, True),
                  (torch.float32, True, True, False),
                  (torch.float32, True, False, True),
                  (torch.float32, False, True, False)]


@pytest.mark.parametrize("D", [64, 48, 33])
@pytest.mark.parametrize("dtype,diagonals,down,up", BATCHED_VSWEEP)
def test_batched_vsweep_equals_frames(cuda, D, dtype, diagonals, down, up):
    C, p1, p2 = batch_cost(cuda, dtype, 40, 112, D)
    kw = dict(down=down, up=up)
    frames = [sgbm_cuda.vsweep(C[i], p1, p2, diagonals, **kw)
              for i in range(FRAMES)]
    plain = sgbm_cuda.vsweep_plain(C, p1, p2, diagonals, **kw)
    out, n = launches(sgbm_cuda.vsweep,
                      lambda: sgbm_cuda.vsweep(C, p1, p2, diagonals, **kw))
    trio = sgbm_cuda.vsweep_design(dtype, diagonals, False, True, D, 112,
                                   FRAMES) == "trio"
    assert n == (down + up if trio else 1 if dtype == torch.int16
                 else (3 if diagonals else 1))
    assert_batch(out, frames, plain)
    if dtype == torch.int16:   # as the paths run it: into H1's s1
        base = torch.randint(0, 1000, C.shape, dtype=torch.int32,
                             device=cuda)
        acc = sgbm_cuda.vsweep(C, p1, p2, diagonals, **kw, acc=base.clone())
        assert torch.equal(acc, base + plain)


@pytest.mark.parametrize("dtype", [torch.int16, torch.float32],
                         ids=["int16", "float32"])
@pytest.mark.parametrize("reverse", [False, True])
def test_batched_vsweep_carry_equals_frames(cuda, dtype, reverse):
    """The carry in and out of a batch: (FRAMES, 3, W, D), each frame's."""
    C, p1, p2 = batch_cost(cuda, dtype, 40, 112, 48)
    ways = dict(down=not reverse, up=reverse)
    first, second = ((C[:, 23:], C[:, :23]) if reverse
                     else (C[:, :23], C[:, 23:]))
    first, second = first.contiguous(), second.contiguous()
    a, carry = sgbm_cuda.vsweep(first, p1, p2, True, **ways,
                                return_carry=True)
    b, carry2 = sgbm_cuda.vsweep(second, p1, p2, True, **ways,
                                 init_carry=carry, return_carry=True)
    assert carry.shape == (FRAMES, 3, 112, 48)
    for i in range(FRAMES):
        ai, ci = sgbm_cuda.vsweep(first[i], p1, p2, True, **ways,
                                  return_carry=True)
        bi, ci2 = sgbm_cuda.vsweep(second[i], p1, p2, True, **ways,
                                   init_carry=ci, return_carry=True)
        for x, y in ((a[i], ai), (carry[i], ci), (b[i], bi),
                     (carry2[i], ci2)):
            assert torch.equal(x, y), i
    whole = sgbm_cuda.vsweep_plain(C, p1, p2, True, **ways)
    joined = torch.cat([b, a], 1) if reverse else torch.cat([a, b], 1)
    assert torch.equal(joined, whole)


@pytest.mark.parametrize("D", [64, 48, 33, 128])
def test_batched_hsweep_and_wta_equal_frames(cuda, D):
    """H5 and H3 (over int16 C with s1 holding the vertical sum, over
    float32 C with and without the bottom-up partial) on a batch."""
    C, p1, p2 = batch_cost(cuda, torch.int16, 40, 112, D)
    wta = (0, 10, 1)
    s1 = sgbm_cuda.cost_hsweep(*batch_pair(cuda, 40, 112), 0, D, 5, 504,
                               400, 1600, True)[1]
    s1 = sgbm_cuda.vsweep(C, p1, p2, True, acc=s1)
    out, n = launches(sgbm_cuda.hsweep_wta_lr, lambda: sgbm_cuda.hsweep_wta_lr(
        C, s1, None, p1, p2, *wta))
    assert n == 1
    assert_batch(out, [sgbm_cuda.hsweep_wta_lr(C[i], s1[i], None, p1, p2,
                                               *wta) for i in range(FRAMES)],
                 sgbm_cuda.hsweep_wta_lr_plain(C, s1, None, p1, p2, *wta))
    Cf, q1, q2 = batch_cost(cuda, torch.float32, 40, 112, D)
    s1f, n = launches(sgbm_cuda.hsweep, lambda: sgbm_cuda.hsweep(Cf, q1, q2))
    assert n == 1
    assert_batch(s1f, [sgbm_cuda.hsweep(Cf[i], q1, q2)
                       for i in range(FRAMES)],
                 sgbm_cuda.hsweep_plain(Cf, q1, q2))
    sv = sgbm_cuda.vsweep(Cf, q1, q2, True)
    svu = sgbm_cuda.vsweep(Cf, q1, q2, True, down=False, up=True)
    for u in (None, svu):
        assert_batch(
            sgbm_cuda.hsweep_wta_lr(Cf, s1f, sv, q1, q2, *wta, u),
            [sgbm_cuda.hsweep_wta_lr(Cf[i], s1f[i], sv[i], q1, q2, *wta,
                                     None if u is None else u[i])
             for i in range(FRAMES)],
            sgbm_cuda.hsweep_wta_lr_plain(Cf, s1f, sv, q1, q2, *wta, u))


@pytest.mark.parametrize("K", [1, 40, 512])
def test_batched_brief_describe_equals_frames(cuda, K):
    """Frames with other stacks and other numbers of valid keypoints (all,
    a few, none), keypoints at every clamped edge."""
    frames = [brief_inputs(cuda, K, integer=s != 1, seed=s)
              for s in range(FRAMES)]
    args = [torch.stack(t) for t in zip(*frames)]
    args[5][1, K // 8:] = False
    args[5][2] = False
    frames = [tuple(a[i] for a in args) for i in range(FRAMES)]
    out, n = launches(orb_cuda.brief_describe,
                      lambda: orb_cuda.brief_describe(*args))
    assert n == 1 and out.shape == (FRAMES, K, 32)
    assert_batch(out, [orb_cuda.brief_describe(*f) for f in frames],
                 orb_cuda.brief_describe_plain(*args))
    assert not out[2].any()


def test_batched_sgbm_and_extract_equal_frames(cuda):
    """The SGBM and the odometer's extract on a batch of 3 frames of the
    corridor, on the card: each frame's disparity, keypoints and
    descriptors as the single-frame calls give them."""
    from openvo_tpu_torch import OdometerConfig, StereoCamera
    from openvo_tpu_torch.io.synthetic import render_stereo_sequence
    from openvo_tpu_torch.models.stereo_odometer import make_pipeline_fns

    seq = render_stereo_sequence(n_frames=FRAMES, img_size=(320, 240),
                                 f=280.0, baseline=0.5, seed=0, step=0.3)
    cam = StereoCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                       {"R": seq["R"], "T": seq["T"]},
                       SGBMParams(num_disparities=64, block_size=5, p1=200,
                                  p2=800, disp12_max_diff=1,
                                  pre_filter_cap=63, uniqueness_ratio=10),
                       (320, 240), device="cuda")
    extract = make_pipeline_fns(cam, OdometerConfig(), False)["extract"]
    lefts, rights = (torch.from_numpy(np.clip(seq[k], 0, 255).astype(
        np.uint8)).to(cuda) for k in ("left", "right"))
    batched = extract(lefts, rights)
    for i in range(FRAMES):
        one = extract(lefts[i], rights[i])
        for name in ("disp", "kp_xy", "desc", "kp_valid"):
            assert torch.equal(getattr(batched, name)[i],
                               getattr(one, name)), (name, i)


@pytest.mark.parametrize("H,W,integer", [(376, 1242, True), (240, 320, False),
                                         (120, 160, True), (50, 60, False)])
def test_resize_levels_equals_plain(cuda, H, W, integer):
    """H6, ORB's pyramid in one launch, equals its plain version bit for
    bit: KITTI and 320x240 frames, a small one, and one whose upper levels
    are held at ORB's least size and so larger than the frame (cut to
    it); one launch, as a batch of 3 frames, each equal to its own call."""
    from openvo_tpu_torch.config import ORBParams
    from openvo_tpu_torch.ops import orb

    rng = np.random.default_rng(H)
    imgs = rng.uniform(0, 255, (3, H, W)).astype(np.float32)
    if integer:
        imgs = np.round(imgs)
    imgs = torch.from_numpy(imgs).to(cuda)
    dims = tuple(orb._level_dims(H, W, ORBParams()))
    n0 = orb_cuda.resize_levels.launches
    out = orb_cuda.resize_levels(imgs[0], dims)
    assert orb_cuda.resize_levels.launches == n0 + 1
    assert out.shape == (len(dims), H, W) and out.dtype == torch.float32
    assert torch.equal(out, orb_cuda.resize_levels_plain(imgs[0], dims))
    assert torch.equal(out.cpu(),
                       orb_cuda.resize_levels_plain(imgs[0].cpu(), dims))
    batch = orb_cuda.resize_levels(imgs, dims)
    assert orb_cuda.resize_levels.launches == n0 + 2
    for i in range(3):
        assert torch.equal(batch[i], orb_cuda.resize_levels(imgs[i], dims))


@pytest.mark.parametrize("scale,levels", [(2.0, 6), (1.5, 8)])
def test_resize_levels_wide_taps_equal_plain(cuda, scale, levels):
    """H6 at other scale factors: at 2.0 the upper levels take up to 39
    taps an output, more than its shared tables hold (the weights are then
    read from device memory), and narrower tiles; a frame and a batch of
    2, bit for bit the plain version's."""
    from openvo_tpu_torch.config import ORBParams
    from openvo_tpu_torch.ops import orb

    H, W = 376, 1242
    dims = tuple(orb._level_dims(H, W, ORBParams(scale_factor=scale,
                                                 nlevels=levels)))
    rng = np.random.default_rng(levels)
    imgs = torch.from_numpy(rng.uniform(0, 255, (2, H, W)).astype(
        np.float32)).to(cuda)
    for x in (imgs[0], imgs):
        out, n = launches(orb_cuda.resize_levels, lambda: (
            orb_cuda.resize_levels(x, dims)))
        assert n == 1
        assert torch.equal(bits(out), bits(orb_cuda.resize_levels_plain(
            x, dims)))


# ---------------------------------------------------------------------------
# H9: ORB's per-pixel detection stages over the pyramid stack
# ---------------------------------------------------------------------------

def bits(t):
    """A float32 tensor's bits, so that equality also holds the sign of 0."""
    return t.view(torch.int32)


def corner_stack(H, W, kind, frames=None, seed=0):
    """A (nl, H, W) stack (or a batch of ``frames``) with ORB's default
    levels: "pyramid", the pyramid of a smoothed random frame (non-integer
    levels 1-7 on a zero canvas); "random", uniform noise on the whole
    canvas (corners on every canvas and level edge); "flat", one value on
    the whole canvas (no pixel passes FAST's pretest at a threshold >= 0;
    at a negative one every pixel is a corner). With the levels' sizes and
    a random bool level-0 mask, all on the CPU."""
    from openvo_tpu_torch.config import ORBParams
    from openvo_tpu_torch.ops import orb

    rng = np.random.default_rng(seed)
    dims = tuple(orb._level_dims(H, W, ORBParams()))
    lead = () if frames is None else (frames,)
    if kind == "flat":
        stack = torch.full(lead + (len(dims), H, W), 7.0)
    elif kind == "pyramid":
        img = rng.uniform(0, 255, lead + (H, W + 2)).astype(np.float32)
        img = np.round((img[..., :-2] + img[..., 1:-1] + img[..., 2:]) / 3)
        stack = orb_cuda.resize_levels_plain(torch.from_numpy(img), dims)
    else:
        stack = torch.from_numpy(rng.uniform(
            0, 255, lead + (len(dims), H, W)).astype(np.float32))
    mask = torch.from_numpy(rng.random(lead + (H, W)) > 0.3)
    return stack, mask, dims


# (kind, edge, FAST threshold, masked): ORB's own border, and borders of 3
# and 0, whose corners reach the canvas's and every level's edges; then
# threshold 0 on noise (nearly every pixel passes FAST's pretest), a flat
# canvas (none passes) and a flat canvas at threshold -1 (every pixel of a
# border box is a corner: each tile's corner list at its fullest)
CORNER_CASES = [("pyramid", 31, 20.0, False), ("pyramid", 31, 20.0, True),
                ("random", 3, 60.0, True), ("random", 0, 80.0, False),
                ("random", 0, 0.0, True), ("flat", 0, 0.0, False),
                ("flat", 3, -1.0, True)]


# KITTI and 320x240 (neither a multiple of the 32-pixel tile), and small
# frames whose clamped levels (2 * 31 + 3 = 65) exceed the frame in one
# axis or both
@pytest.mark.parametrize("H,W", [(376, 1242), (240, 320), (70, 90),
                                 (50, 120), (33, 45)])
@pytest.mark.parametrize("kind,edge,threshold,masked", CORNER_CASES)
def test_corner_keys_equals_plain(cuda, H, W, kind, edge, threshold,
                                  masked):
    """H9 equals its plain version bit for bit on the whole canvas, on the
    card and on the CPU, for both rankings (key, and fkey with it), in
    one launch each."""
    from openvo_tpu_torch.ops import orb

    stack, mask, dims = corner_stack(H, W, kind, seed=H + edge)
    mask = mask if masked else None
    args = (dims, edge, threshold)
    cpu = orb.corner_keys_plain(stack, mask, *args, True)
    stack = stack.to(cuda)
    mask = None if mask is None else mask.to(cuda)
    for with_score in (False, True):
        (key, fkey), n = launches(orb_cuda.corner_keys, lambda: (
            orb_cuda.corner_keys(stack, mask, *args, with_score)))
        assert n == 1 and key.shape == stack.shape
        plain = orb.corner_keys_plain(stack, mask, *args, with_score)
        assert torch.equal(bits(key), bits(plain[0]))
        assert torch.equal(bits(key.cpu()), bits(cpu[0]))
        if with_score:
            assert torch.equal(bits(fkey), bits(plain[1]))
            assert torch.equal(bits(fkey.cpu()), bits(cpu[1]))
        else:
            assert fkey is None
    # corners everywhere but on a flat canvas at a threshold >= 0
    assert bool(torch.isfinite(key).any()) == (kind != "flat"
                                               or threshold < 0)


@pytest.mark.parametrize("kind,edge,threshold,masked", CORNER_CASES)
def test_batched_corner_keys_equals_frames(cuda, kind, edge, threshold,
                                           masked):
    """H9 over a batch of 3 frames in one launch equals its 3 single-frame
    launches and the plain version, on each of 3 calls."""
    from openvo_tpu_torch.ops import orb

    stack, mask, dims = corner_stack(70, 130, kind, FRAMES, seed=edge)
    stack = stack.to(cuda)
    mask = mask.to(cuda) if masked else None
    args = (dims, edge, threshold, True)
    plain = orb.corner_keys_plain(stack, mask, *args)
    for _ in range(3):
        out, n = launches(orb_cuda.corner_keys, lambda: (
            orb_cuda.corner_keys(stack, mask, *args)))
        assert n == 1
        singles = [orb_cuda.corner_keys(
            stack[i], None if mask is None else mask[i], *args)
            for i in range(FRAMES)]
        assert_batch(tuple(bits(t) for t in out),
                     [tuple(bits(t) for t in one) for one in singles],
                     tuple(bits(t) for t in plain))


@pytest.mark.parametrize("frames", [1, 3, 8, 16])
def test_batched_pyramid_and_keys_equal_frames(cuda, frames):
    """H6 and H9 over batches of 1, 3, 8 and 16 frames, one launch each:
    every frame's stack and keys (both rankings, masked) equal its own
    single-frame launch and the plain version, bit for bit."""
    from openvo_tpu_torch.config import ORBParams
    from openvo_tpu_torch.ops import orb

    p = ORBParams()
    H, W = 240, 320
    rng = np.random.default_rng(frames)
    img = rng.uniform(0, 255, (frames, H, W + 2)).astype(np.float32)
    imgs = torch.from_numpy(np.round(
        (img[..., :-2] + img[..., 1:-1] + img[..., 2:]) / 3)).to(cuda)
    masks = torch.from_numpy(rng.random((frames, H, W)) > 0.3).to(cuda)
    dims = tuple(orb._level_dims(H, W, p))
    stack, n = launches(orb_cuda.resize_levels, lambda: (
        orb_cuda.resize_levels(imgs, dims)))
    assert n == 1
    assert_batch(bits(stack), [bits(orb_cuda.resize_levels(imgs[i], dims))
                               for i in range(frames)],
                 bits(orb_cuda.resize_levels_plain(imgs, dims)))
    args = (dims, p.edge_threshold, float(p.fast_threshold), True)
    out, n = launches(orb_cuda.corner_keys, lambda: (
        orb_cuda.corner_keys(stack, masks, *args)))
    assert n == 1
    assert bool(torch.isfinite(out[0]).any())
    assert_batch(tuple(bits(t) for t in out),
                 [tuple(bits(t) for t in orb_cuda.corner_keys(
                     stack[i], masks[i], *args)) for i in range(frames)],
                 tuple(bits(t) for t in orb.corner_keys_plain(
                     stack, masks, *args)))


def test_corner_keys_rejects_wrong_input(cuda):
    stack, mask, dims = corner_stack(40, 60, "random")
    stack, mask = stack.to(cuda), mask.to(cuda)
    args = (dims, 3, 20.0)
    with pytest.raises(TypeError):
        orb_cuda.corner_keys(stack.double(), mask, *args)
    with pytest.raises(TypeError):
        orb_cuda.corner_keys(stack, mask.to(torch.uint8), *args)
    with pytest.raises(ValueError, match="device mismatch"):
        orb_cuda.corner_keys(stack, mask.cpu(), *args)
    with pytest.raises(ValueError):
        orb_cuda.corner_keys(stack, mask[:, :30].contiguous(), *args)
    with pytest.raises(ValueError):
        orb_cuda.corner_keys(stack[0], mask, *args)
    with pytest.raises(ValueError, match="levels"):
        orb_cuda.corner_keys(stack, mask, dims[:-1], 3, 20.0)
    with pytest.raises(ValueError, match="contiguous"):
        orb_cuda.corner_keys(stack.transpose(1, 2).contiguous().transpose(
            1, 2), mask, *args)


# ---------------------------------------------------------------------------
# the loops JAX runs as lax.while_loop: H7 (speckle labelling) and H8 (the
# rigid clique)
# ---------------------------------------------------------------------------

SPECKLE_MAPS = {   # name -> map maker of (H, W), at its own size
    "spiral": lambda H=96, W=128: loop_cases.spiral(H, W),
    "islands-0": lambda H=64, W=96: loop_cases.islands(0, H, W),
    "islands-1": lambda H=75, W=131: loop_cases.islands(1, H, W),
    "all-invalid": lambda H=40, W=70: loop_cases.uniform(H, W, False),
    "one-component": lambda H=40, W=70: loop_cases.uniform(H, W, True),
    # components across H7's 32x32 tile edges in every direction: tiles'
    # own checkerboard, runs of 3x5 straddling every edge, diagonal bands
    "checkerboard-32x32": lambda H=96, W=160: loop_cases.checkerboard(
        H, W, 32, 32),
    "checkerboard-3x5": lambda H=70, W=100: loop_cases.checkerboard(
        H, W, 3, 5),
    "staircase": lambda H=100, W=140: loop_cases.staircase(H, W),
}
KITTI = (376, 1242)


def sgbm_map(dev, H=96, W=200):
    """An SGBM disparity (speckle off) of a textured pair and its mask."""
    left, right = image_pair(dev, H, W)
    d = sgbm.sgbm_disparity16(left, right, SGBMParams(num_disparities=64))
    return d, d != -16


def assert_speckle_equals_plain(d, valid, window, max_diff=32, calls=5):
    """H7 against its plain version on the card and on the CPU: labels and
    masks equal; one launch a call, every one of ``calls`` calls alike (a
    race of the union-find would show as calls that differ)."""
    n0 = speckle_cuda.speckle_keep.launches
    labels, keep = speckle_cuda.speckle_keep(d, valid, max_diff, window)
    assert speckle_cuda.speckle_keep.launches == n0 + 1
    assert labels.dtype == torch.int32 and keep.dtype == torch.bool
    for _ in range(calls - 1):
        again = speckle_cuda.speckle_keep(d, valid, max_diff, window)
        assert torch.equal(again[0], labels) and torch.equal(again[1], keep)
    for dev in (d.device, torch.device("cpu")):
        want = sgbm.speckle_keep_plain(d.to(dev), valid.to(dev), max_diff,
                                       window)
        assert torch.equal(labels.to(dev), want[0])
        assert torch.equal(keep.to(dev), want[1])
    return labels, keep


@pytest.mark.parametrize("kitti", [False, True], ids=["own", "kitti"])
@pytest.mark.parametrize("name", list(SPECKLE_MAPS) + ["sgbm"])
@pytest.mark.parametrize("window", [0, 60])
def test_speckle_keep_equals_plain(cuda, name, window, kitti):
    """H7 on the CPU tests' maps (the spiral, random islands), one
    component, none, maps whose components cross the tile edges, and a
    real SGBM disparity, at two windows, each map at its own size and at
    KITTI's 1242x376, 5 calls alike."""
    if name == "sgbm":
        d, valid = sgbm_map(cuda, *(KITTI if kitti else ()))
    else:
        d, valid = (torch.from_numpy(x).to(cuda) for x in
                    SPECKLE_MAPS[name](*(KITTI if kitti else ())))
    labels, keep = assert_speckle_equals_plain(d, valid, window)
    if name == "one-component":
        assert int(labels.max()) == 0 and bool(keep.all())
    if name == "all-invalid":
        assert torch.equal(labels.flatten().cpu(),
                           torch.arange(labels.numel(), dtype=torch.int32))
        assert not bool(keep.any())


@pytest.mark.parametrize("H, W", [(96, 128), (45, 70), (376, 1242)])
def test_speckle_keep_batch_equals_frames(cuda, H, W):
    """A (B, H, W) stack is one launch and one flat index space: each
    frame's labels its own call's, offset by b*H*W; int32 disparities (as
    the row tiles gather them) give the int16 ones' result. Frames whose
    height is not a multiple of the tile's (45, 376) end in part tiles
    that stay inside their frame."""
    maps = [loop_cases.islands(s, H, W) for s in range(3)]
    maps.append(loop_cases.spiral(H, W))
    d = torch.from_numpy(np.stack([m[0] for m in maps])).to(cuda)
    valid = torch.from_numpy(np.stack([m[1] for m in maps])).to(cuda)
    labels, keep = assert_speckle_equals_plain(d, valid, 60)
    n = H * W
    for b in range(len(maps)):
        one = speckle_cuda.speckle_keep(d[b].contiguous(),
                                        valid[b].contiguous(), 32, 60)
        assert torch.equal(labels[b], one[0] + b * n)
        assert torch.equal(keep[b], one[1])
    wide = speckle_cuda.speckle_keep(d.to(torch.int32), valid, 32, 60)
    assert torch.equal(wide[0], labels) and torch.equal(wide[1], keep)


def test_speckle_keep_rejects_wrong_input(cuda):
    d, valid = sgbm_map(cuda, 40, 80)
    with pytest.raises(ValueError, match="CUDA"):
        speckle_cuda.speckle_keep(d.cpu(), valid.cpu(), 32, 10)
    with pytest.raises(TypeError):
        speckle_cuda.speckle_keep(d.float(), valid, 32, 10)
    huge = torch.zeros((1, 1, 1), dtype=torch.int16, device=cuda).expand(
        2 ** 16, 2 ** 8, 2 ** 8)
    with pytest.raises(ValueError, match="int32"):
        speckle_cuda.speckle_keep(huge, huge > 0, 32, 10)


CLIQUE_CASES = {
    # name -> (clouds, points, loop_cases.clouds' options)
    "one cloud": (1, 512, {}),
    "nan rows": (2, 512, dict(nan_rows=40)),
    "ties": (2, 512, dict(ties=30)),
    "all invalid": (2, 512, dict(valid=0.0)),
    "all nan": (1, 64, dict(nan_rows=64, valid=1.0)),
    "a rig's 16": (16, 512, {}),
    "n not a multiple of 32": (3, 100, {}),
    "one point": (2, 1, {}),
    "n a multiple of 16, not 32 (byte loads)": (2, 48, {}),
    "n 480": (2, 480, {}),
    "n 513, the block design": (2, 513, {}),
    "shared memory above 48 KB": (2, 700, {}),
    "cons from global memory": (2, 1500, {}),
}


@pytest.mark.parametrize("name", CLIQUE_CASES)
def test_greedy_clique_equals_plain(cuda, name):
    """H8 against its plain version on the card, and the filter on the
    card against the CPU: equal memberships; one launch for the batch."""
    from openvo_tpu_torch.pose import rigid_clique

    B, N, kw = CLIQUE_CASES[name]
    seed = list(CLIQUE_CASES).index(name)
    prev, pts, mask = (torch.from_numpy(x).to(cuda)
                       for x in loop_cases.clouds(seed, B, N, **kw))
    cons, num = rigid_clique.consistency(prev, pts, mask, 0.05)
    n0 = clique_cuda.greedy_clique.launches
    got = clique_cuda.greedy_clique(cons, num)
    assert clique_cuda.greedy_clique.launches == n0 + 1
    assert got.dtype == torch.int32 and got.shape == (B, N)
    assert torch.equal(got, rigid_clique.greedy_clique_plain(cons, num))
    for b in range(B):
        assert torch.equal(got[b], clique_cuda.greedy_clique(cons[b], num[b]))
    filt = rigid_clique.rigid_body_filter(prev, pts, mask, 0.05)
    assert torch.equal(filt.cpu(), rigid_clique.rigid_body_filter(
        prev.cpu(), pts.cpu(), mask.cpu(), 0.05))
    if name == "one cloud":   # a chain of over 300 picks at N = 512
        assert 300 < int(got.sum()) - 1 < N
    if name == "all invalid":
        assert not bool(filt.any())


@pytest.mark.parametrize("N", [33, 200, 512, 700])
@pytest.mark.parametrize("counts", ["column sums", "zeros", "random"])
def test_greedy_clique_any_matrix_equals_plain(cuda, N, counts):
    """H8 on matrices that consistency() does not make: cons not symmetric
    (compatible starts as row seed, then counts column hits) and num not
    its column sums (zeros: every pick ties at 0 and the first may be a
    member; random, negative too), against the plain version."""
    from openvo_tpu_torch.pose import rigid_clique

    rng = np.random.default_rng(N)
    cons = torch.from_numpy(rng.random((3, N, N)) < [[[0.5]], [[0.8]],
                                                    [[0.97]]]).to(cuda)
    num = {"column sums": lambda: cons.sum(-2, dtype=torch.int32),
           "zeros": lambda: torch.zeros((3, N), dtype=torch.int32,
                                        device=cuda),
           "random": lambda: torch.from_numpy(rng.integers(
               -3, 6, (3, N)).astype(np.int32)).to(cuda)}[counts]()
    got = clique_cuda.greedy_clique(cons, num)
    assert torch.equal(got, rigid_clique.greedy_clique_plain(cons, num))


def test_greedy_clique_rejects_wrong_input(cuda):
    cons = torch.ones((4, 4), dtype=torch.bool, device=cuda)
    num = cons.sum(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        clique_cuda.greedy_clique(cons.cpu(), num.cpu())
    with pytest.raises(TypeError):
        clique_cuda.greedy_clique(cons, num.long())
    big = torch.zeros((4097, 4097), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="points"):
        clique_cuda.greedy_clique(big, big.sum(0, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the pose fits: H10 (the whole Kabsch fit) and H11 (the batched Jacobi SVD
# of the mono path). Bit-equal to their plain versions on the card, whose
# float64 sqrt is correctly rounded as the kernels' (torch's on the CPU is
# not always: an ulp apart on about 0.7% of values).
# ---------------------------------------------------------------------------


def same_bits(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def assert_fit_equals_plain(src, dst, mask):
    n0 = jacobi_cuda.kabsch_fit.launches
    got = jacobi_cuda.kabsch_fit(src, dst, mask)
    assert jacobi_cuda.kabsch_fit.launches == n0 + 1
    assert same_bits(got, kabsch.kabsch_fit_plain(src, dst, mask))
    return got


def fit_inputs(case, dev):
    if case == "clouds":
        clouds = svd_cases.clouds(0, 100)
    elif case == "degenerate":
        clouds = svd_cases.degenerate_clouds()
    elif case == "random masks, 1,000 points":
        rng = np.random.default_rng(3)
        src = rng.normal(0, 4, (6, 1000, 3)).astype(np.float32)
        dst = (src @ svd_cases.rotation(rng.normal(0, 0.2, 3)).T
               + rng.normal(0, 0.1, src.shape)).astype(np.float32)
        clouds = (src, dst, rng.random((6, 1000)) < rng.random((6, 1)))
    else:   # the most points a block folds, and one point
        big = svd_cases.clouds(4, 2, 16384)
        clouds = (big[0], big[1], big[2])
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in clouds)


@pytest.mark.parametrize("case", ["clouds", "degenerate",
                                  "random masks, 1,000 points",
                                  "16,384 points"])
def test_kabsch_fit_equals_plain(cuda, case):
    """H10 on general, planar, 3-point, 10-point and collinear clouds; on
    degenerate ones (2 valid rows, NaN in a valid row, inf and NaN in
    invalid rows, planar, 3 points, collinear, none valid); on random masks
    over 1,000 points (4 points a thread) and at MAX_FIT_POINTS; and
    through the operator, as ``kabsch.kabsch`` calls it."""
    src, dst, mask = fit_inputs(case, cuda)
    T = assert_fit_equals_plain(src, dst, mask)
    assert torch.equal(torch.ops.openvo_torch.kabsch_fit(src, dst, mask)
                       .nan_to_num(7.0), T.nan_to_num(7.0))
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", [(), (1,), (2,), (16,), (2, 8)])
def test_kabsch_fit_at_the_paths_shapes(cuda, shape):
    """The batches the paths give H10 (one fit; a frame's two attempts; a
    rig's 8 cameras' two; a stream's frame) through ``kabsch.kabsch``,
    each fit equal to its own launch."""
    n = int(np.prod(shape, dtype=int))
    src, dst, mask = (torch.from_numpy(x[:n]).to(cuda)
                      for x in svd_cases.clouds(n, max(n, 1), 512))
    src, dst = src.reshape(shape + (512, 3)), dst.reshape(shape + (512, 3))
    mask = mask.reshape(shape + (512,))
    n0 = jacobi_cuda.kabsch_fit.launches
    T = kabsch.kabsch(src, dst, mask)
    assert jacobi_cuda.kabsch_fit.launches == n0 + 1
    assert T.shape == shape + (4, 4)
    flat = [x.reshape((-1,) + x.shape[len(shape):]) for x in (src, dst, mask)]
    assert same_bits(T.reshape(-1, 4, 4), kabsch.kabsch_fit_plain(*flat))
    for i in range(n):
        one = jacobi_cuda.kabsch_fit(*(x[i:i + 1] for x in flat))
        assert same_bits(one[0], T.reshape(-1, 4, 4)[i])


def jacobi_inputs(name):
    rng = np.random.default_rng(7)
    if name == "five-point rows":
        return svd_cases.five_point_rows(0, 64)
    if name == "essential":
        return svd_cases.essentials(1, 8)
    if name == "gram":
        a = svd_cases.epipolar_rows(*svd_cases.two_view(rng, 300))
        return (a.T @ a)[None]
    if name == "degenerate 3x3":
        return svd_cases.degenerate_3x3()
    if name == "one 3x3":
        return svd_cases.essentials(2, 1)
    if name == "NaN and inf 3x3":
        a = rng.normal(size=(12, 3, 3))
        a[1, 0, 0], a[4, 2, 1], a[7] = np.nan, np.inf, np.nan
        return a
    if name == "NaN 9x9":
        a = rng.normal(size=(5, 9, 9))
        a[2, 4, 4] = np.nan
        return a
    if name == "done beside running 9x9":
        # the identity and a diagonal are done after one sweep, the Grams
        # run 7-9: each stops on its own
        g = svd_cases.epipolar_rows(*svd_cases.two_view(rng, 200))
        return np.stack([np.eye(9), g.T @ g, np.diag(np.arange(9.0, 0, -1)),
                         rng.normal(size=(9, 9))])
    if name == "zeros 5x9":
        return np.zeros((3, 5, 9))
    if name == "equal singular values 9x9":
        q = np.linalg.qr(rng.normal(size=(9, 9)))[0]
        return np.stack([np.eye(9), 3.0 * q, np.diag([2.0] * 5 + [1.0] * 4)])
    if name == "rank 3 of 9x9":
        b = rng.normal(size=(4, 9, 3))
        return b @ rng.normal(size=(4, 3, 9))
    m, n = (int(x) for x in name.split()[-1].split("x"))
    return rng.normal(size=(17, m, n))


JACOBI_CASES = ["five-point rows", "essential", "gram", "degenerate 3x3",
                "one 3x3", "NaN and inf 3x3", "NaN 9x9",
                "done beside running 9x9", "zeros 5x9",
                "equal singular values 9x9", "rank 3 of 9x9", "random 8x9",
                "random 2x9", "random 9x4", "random 7x7", "random 1x1",
                "random 9x1", "random 1x9", "random 5x9", "random 9x9",
                "random 3x3"]


def assert_svd_equals_plain(a):
    n0 = jacobi_cuda.jacobi_svd.launches
    got = jacobi_cuda.jacobi_svd(a, kabsch.JACOBI_TOL,
                                 kabsch.JACOBI_MAX_SWEEPS)
    assert jacobi_cuda.jacobi_svd.launches == n0 + 1
    for x, y in zip(got, kabsch.jacobi_svd_plain(a)):
        assert same_bits(x, y)
    return got


@pytest.mark.parametrize("name", JACOBI_CASES)
def test_jacobi_svd_equals_plain(cuda, name):
    """H11 on the mono path's shapes ((64, 5, 9) five-point rows, a 9x9
    Gram, (8, 3, 3) essential matrices, one 3x3), degenerate, NaN, done
    (beside running) and random matrices of 1-9 rows and columns (float32
    where wide, LAPACK's LQ path; the 5x9, 9x9 and 3x3 instances and the
    generic one): S, V, U and the sweeps equal, and each member of the
    batch equal to its own launch."""
    a = kabsch.jacobi_input(torch.from_numpy(jacobi_inputs(name))).to(cuda)
    got = assert_svd_equals_plain(a)
    for i in range(min(len(a), 8)):
        one = jacobi_cuda.jacobi_svd(a[i:i + 1], kabsch.JACOBI_TOL,
                                     kabsch.JACOBI_MAX_SWEEPS)
        for x, y in zip(got, one):
            assert same_bits(x[i], y[0])
    torch.cuda.synchronize()


def test_svd_on_the_card_runs_h11_and_no_torch_svd(cuda, monkeypatch):
    """``kabsch.svd`` of CUDA tensors launches H11 once a call, never
    ``torch.linalg.svd``; NaN matrices give NaN."""
    def tripwire(*_a, **_k):
        raise AssertionError("torch.linalg.svd ran on the card")

    monkeypatch.setattr(torch.linalg, "svd", tripwire)
    a = torch.from_numpy(svd_cases.five_point_rows(3, 4)).to(cuda).float()
    a[1, 0, 0] = float("nan")
    n0 = jacobi_cuda.jacobi_svd.launches
    U, S, Vh = kabsch.svd(a)
    assert jacobi_cuda.jacobi_svd.launches == n0 + 1 and U is None
    assert torch.isnan(S[1]).all() and torch.isfinite(S[0]).all()
    assert S.shape == (4, 5) and Vh.shape == (4, 9, 9)


def test_jacobi_kernels_reject_wrong_input(cuda):
    pts = torch.zeros((2, 5, 3), device=cuda)
    mask = torch.ones((2, 5), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        jacobi_cuda.kabsch_fit(pts.cpu(), pts.cpu(), mask.cpu())
    with pytest.raises(TypeError, match="dtype"):
        jacobi_cuda.kabsch_fit(pts.double(), pts, mask)
    with pytest.raises(TypeError, match="dtype"):
        jacobi_cuda.kabsch_fit(pts, pts, mask.int())
    with pytest.raises(ValueError, match="shape"):
        jacobi_cuda.kabsch_fit(pts, pts, mask[:, :4])
    big = torch.zeros((1, jacobi_cuda.MAX_FIT_POINTS + 1, 3), device=cuda)
    with pytest.raises(ValueError, match="points"):
        jacobi_cuda.kabsch_fit(big, big, big[..., 0] > 0)
    a = torch.zeros((2, 3, 3), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="rows and columns"):
        jacobi_cuda.jacobi_svd(torch.zeros((1, 10, 3), dtype=torch.float64,
                                           device=cuda), 1e-14, 12)
    with pytest.raises(TypeError, match="dtype"):
        jacobi_cuda.jacobi_svd(a.float(), 1e-14, 12)
    with pytest.raises(TypeError, match="dtype"):   # wide: float32 only
        jacobi_cuda.jacobi_svd(torch.zeros((1, 5, 9), dtype=torch.float64,
                                           device=cuda), 1e-14, 12)


def test_compute_3d_is_captured_and_returns_copies(cuda):
    """StereoCamera.compute_3d on the card replays a graph captured per
    (color, preprocessed, input shapes): its outputs equal the eager
    function's bit for bit, and a later call leaves an earlier result as
    it was (JAX returns fresh arrays)."""
    from openvo_tpu_torch import StereoCamera, _graph
    from openvo_tpu_torch.io.synthetic import render_stereo_sequence

    seq = render_stereo_sequence(n_frames=2, img_size=(320, 240), f=280.0,
                                 baseline=0.5, seed=0, step=0.3,
                                 yaw_rate=0.004)
    sgbm_dict = {"minDisparity": 0, "numDisparities": 64, "blockSize": 5,
                 "P1": 200, "P2": 800, "disp12MaxDiff": 1,
                 "preFilterCap": 63, "uniquenessRatio": 10,
                 "speckleWindowSize": 100, "speckleRange": 2}
    cam = StereoCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                       {"R": seq["R"], "T": seq["T"]}, sgbm_dict, (320, 240),
                       device=cuda)
    frames = [[np.clip(seq[s][i], 0, 255).astype(np.uint8)
               for s in ("left", "right")] for i in range(2)]
    with _graph.disable_capture():
        eager = [cam.compute_3d(*f) for f in frames]
    first = cam.compute_3d(*frames[0])
    kept = [x.clone() for x in first]
    second = cam.compute_3d(*frames[1])
    assert len(cam._compute_3d_cache) == 1
    for got, want in ((first, eager[0]), (second, eager[1]),
                      (kept, eager[0])):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    for a, b in zip(first, kept):
        assert torch.equal(a, b)
    assert not torch.equal(first[1], second[1])
