"""The arithmetic of the metrics, on records made up for the purpose."""

import types

import numpy as np
import pytest
import torch

from vobench.harness import drive, roofline, spec, trace


def ctx(**kw):
    rec = drive.Records()
    for k, v in kw.items():
        setattr(rec, k, v)
    return types.SimpleNamespace(
        traffic={"chunk": 16}, records=rec, setup_s=21.5, trace=None,
        layers=None,
        config={"camera": {"width": 1241, "height": 376},
                "sgbm": {"num_disparities": 128, "block_size": 5,
                         "num_paths": 5}})


def read(name, c):
    return spec.reader(name).read(c)


def test_step_ms_is_the_window_over_its_steps():
    c = ctx(window_s=10.0, window_steps=2500, window_frames=20000,
            latency_s=[0.004] * 2500)
    assert read("step_ms", c) == pytest.approx(4.0)
    assert read("frames_per_s", c) == pytest.approx(2000.0)
    assert read("setup_s", c) == 21.5
    assert read("step_ms", ctx()) is None


def test_step_p95_is_over_every_step():
    lat = list(np.arange(1, 101) * 1e-3)   # 1..100 ms
    c = ctx(window_s=5.05, window_steps=100, latency_s=lat)
    assert read("step_p95_ms", c) == pytest.approx(
        np.percentile(np.arange(1, 101), 95))
    assert read("step_p95_ms", c) == pytest.approx(95.05)
    assert read("step_p95_ms", ctx()) is None


def test_frames_per_s_counts_every_frame_of_the_window():
    c = ctx(window_s=10.0, window_steps=275, window_frames=4400)
    assert read("frames_per_s", c) == pytest.approx(440.0)
    assert read("frames_per_s", ctx()) is None


def test_layer_readers():
    c = ctx(window_steps=100, window_frames=100)
    for name in ("device_idle.live", "kernels_per_step.live",
                 "depth_roofline.live", "orb_ms.live"):
        assert read(name, c) is None   # no trace, nothing read
    c.trace = trace.Trace(window_s=0.3, busy_s=0.2, kernels=6400, units=10,
                          device_ops=[], idle_gaps=[])
    assert read("device_idle.live", c) == pytest.approx(100 / 3)
    assert read("device_idle.replay", c) == pytest.approx(100 / 3)
    assert read("kernels_per_step.live", c) == 640
    c.layers = {"depth_ms": 1.0, "orb_ms": 0.5, "frames_per_call": 1}
    ops, _ = roofline.sgbm_work(376, 1241, 128, 5, 5)
    assert read("depth_roofline.live", c) == pytest.approx(
        100 * ops / 67e12 / 1e-3)
    assert read("orb_ms.live", c) == 0.5
    s = ctx(window_steps=10, window_frames=160)
    s.trace = c.trace
    s.layers = {"depth_ms": 16.0, "orb_ms": 3.2, "frames_per_call": 16}
    assert read("kernels_per_frame.replay", s) == 40
    assert read("orb_ms.replay", s) == pytest.approx(0.2)
    assert read("depth_roofline.replay", s) == pytest.approx(
        read("depth_roofline.live", c))


def test_sgbm_work_counts_the_algorithm():
    ops, nbytes = roofline.sgbm_work(376, 1242, 128, 5, 5)
    assert ops == 60 * 376 * 1242 * 128
    assert nbytes == 5 * 376 * 1242
    least, by = roofline.least_seconds(ops, nbytes)
    assert by == "operations" and least == pytest.approx(ops / 67e12)


def test_union_of_intervals():
    assert trace._union([(0, 2), (1, 3), (5, 6), (6, 7)]) == [[0, 3], [5, 7]]


def test_sample_is_drawn_from_the_seed():
    cur = types.SimpleNamespace(disp=torch.zeros(3), kp_xy=torch.zeros(2),
                                desc=torch.zeros(2), kp_valid=torch.zeros(2))

    def draw(seed):
        s = drive.Sample(4, seed, cur)
        for i in range(1000):
            cur.disp.fill_(i)
            s.offer(i, cur)
        kept = s.features()
        assert all(int(v[0][0]) == k for k, v in kept.items())
        return sorted(kept)

    assert draw(5) == draw(5) and draw(5) != draw(6)
    assert len(draw(5)) == 4 and max(draw(5)) < 1000
