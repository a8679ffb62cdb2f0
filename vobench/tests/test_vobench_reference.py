"""The plain reference against the program's CPU path (its plain versions)
on tiny sequences, stage by stage and through whole runs of each cell."""

import dataclasses

import numpy as np
import pytest
import torch

from vobench.harness import main
from vobench.reference import odometry as ref
from vobench.reference import sgbm as ref_sgbm
from vobench.tests.conftest import CELLS, tiny


@pytest.mark.parametrize("name", CELLS)
def test_a_run_agrees_with_the_reference(name):
    out = main.run_cell(tiny(name), 2 ** 31 + 7, 1.0, False, "cpu", 0.0)
    assert out["correct"], out["checks"]
    assert all(e["value"] == 0 for e in out["checks"].values())
    assert out["attempted"] > 0 and out["failed"] == 0


# settings of configurations the benchmark has no cell for yet: the
# filters on (the rigid clique, the outlier pass), and block 13 with
# OpenCV's penalties (no int16 sentinel: the float32 cost path)
VARIANTS = {
    "filters": ("odometer", {"rigidity_threshold": 0.05,
                             "outlier_threshold": 0.01}),
    "block13": ("sgbm", {"block_size": 13, "p1": 8 * 169,
                         "p2": 32 * 169}),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", ["kitti-stereo.live", "kitti-rig8.live"])
def test_a_run_of_other_settings_agrees(name, variant):
    cell = tiny(name)
    group, change = VARIANTS[variant]
    cell.config[group] = dict(cell.config[group], **change)
    out = main.run_cell(cell, 2 ** 31 + 8, 1.0, False, "cpu", 0.0)
    assert out["correct"], out["checks"]
    assert all(e["value"] == 0 for e in out["checks"].values())


def pair(seed, size=(2, 64, 128)):
    g = torch.Generator().manual_seed(seed)
    left = torch.randint(0, 256, size, generator=g).to(torch.float32)
    right = torch.roll(left, -5, dims=-1)
    right[..., -5:] = 0
    return left, right


@pytest.mark.parametrize("block", [5, 13])
def test_sgbm_equals_the_programs_plain_sgbm(block):
    """Block 5 runs the int16 path, block 13 the float32 one."""
    from openvo_tpu_torch.io.kitti import KITTI_SGBM
    from openvo_tpu_torch.ops.sgbm import sgbm_disparity16

    params = dataclasses.replace(KITTI_SGBM, num_disparities=32,
                                 block_size=block, p1=8 * block ** 2,
                                 p2=32 * block ** 2)
    mine = ref.SGBM(**dataclasses.asdict(params))
    left, right = pair(1)
    assert torch.equal(ref_sgbm.disparity16(left, right, mine),
                       sgbm_disparity16(left, right, params))


def test_filters_equal_the_programs():
    """The rigid clique and the outlier pass on clouds with outliers, NaN
    rows and padding."""
    from openvo_tpu_torch.pose.outlier import outlier_filter
    from openvo_tpu_torch.pose.rigid_clique import rigid_body_filter
    from vobench.reference import filters

    g = torch.Generator().manual_seed(4)
    for trial in range(6):
        n = 64
        src = torch.randn((n, 3), generator=g) * 3
        R = torch.linalg.qr(torch.randn(3, 3, generator=g))[0]
        dst = src @ R.T + torch.tensor([0.2, 0.0, 0.5])
        bad = torch.rand(n, generator=g) < 0.2
        dst[bad] += torch.randn((int(bad.sum()), 3), generator=g)
        dst += 1e-3 * torch.randn((n, 3), generator=g)
        mask = torch.rand(n, generator=g) > 0.15
        if trial == 1:
            src[3] = float("nan")
        if trial == 2:
            mask[:] = False
        for thr in (0.05, 0.3):
            theirs = rigid_body_filter(src, dst, mask, thr) > 0
            assert torch.equal(filters.rigid_clique(src, dst, mask, thr),
                               theirs), (trial, thr)
        if trial != 2:
            assert torch.equal(filters.outlier_pass(src, dst, mask, 0.01),
                               outlier_filter(src, dst, mask, 0.01))


def test_orb_and_fit_equal_the_programs_plain_versions():
    from openvo_tpu_torch import ORBParams
    from openvo_tpu_torch.ops.orb import detect_and_compute
    from openvo_tpu_torch.pose.kabsch import kabsch_fit_plain
    from vobench.reference.geometry import kabsch_fit_plain as mine_fit
    from vobench.reference.orb import detect_and_compute as mine_orb

    img, _ = pair(2, (2, 96, 160))
    mask = torch.ones(img.shape, dtype=torch.uint8)
    params = ORBParams()
    theirs = detect_and_compute(img, mask, params)
    mine = mine_orb(img, mask, ref.ORB(**dataclasses.asdict(params)))
    for k in ("xy", "desc", "valid", "angle"):
        assert torch.equal(theirs[k], mine[k]), k
    g = torch.Generator().manual_seed(3)
    src = torch.randn((4, 50, 3), generator=g)
    dst = src @ torch.linalg.qr(torch.randn(3, 3, generator=g))[0] + 0.3
    m = torch.rand((4, 50), generator=g) > 0.2
    assert torch.equal(mine_fit(src, dst, m), kabsch_fit_plain(src, dst, m))


def test_the_state_machine_keeps_the_reference_semantics():
    """A frame with too few keypoints skips as ``keypoints``; the first
    frame is taken without a pose."""
    odo = ref.params(tiny("kitti-stereo.live").config)[2]
    empty = ref.Features(torch.zeros((4, 4, 3)), torch.zeros((4, 4)),
                         torch.zeros((8, 2)),
                         torch.zeros((8, 32), dtype=torch.uint8),
                         torch.zeros(8, dtype=torch.bool))
    st = ref.initial_state()
    st, ok, n = ref.step(st, empty, odo)
    assert not ok and st.skip_code == ref.SKIP_KEYPOINTS and st.skipped == 1
    full = empty._replace(kp_valid=torch.ones(8, dtype=torch.bool))
    st2 = ref.initial_state()
    odo_few = dataclasses.replace(odo, min_matches=4)
    st2, ok, n = ref.step(st2, full, odo_few)
    assert ok and st2.cur is full and n == 0
    assert np.array_equal(st2.c_T_w.numpy(), np.eye(4, dtype=np.float32))
