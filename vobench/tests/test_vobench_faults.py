"""``correct`` comes out false: for the control (the reference in lower
precision in the program's place), and for runs driven through a program
broken underneath, once for each fault a cell can have."""

import pytest
import torch
from torch.utils._pytree import tree_map

from vobench.harness import check, main, render, spec
from vobench.tests.conftest import CELLS, tiny


def run(name, seed=11, **traffic):
    cell = tiny(name)
    cell.traffic.update(traffic)
    return main.run_cell(cell, seed, 1.0, False, "cpu", 0.0)


def wrap_step(monkeypatch, change):
    """Replace the odometer's state-machine step by ``change(step)``."""
    import openvo_tpu_torch.models.stereo_odometer as so

    orig = so.make_feats_step
    monkeypatch.setattr(so, "make_feats_step",
                        lambda cfg, attempt: change(orig(cfg, attempt)))


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = tiny(name)
    L, R, _ = render.render_sequence(12, cell.config["camera"],
                                     cell.traffic["motion"],
                                     cell.config["cameras"], "cpu")
    lefts, rights = main._host(L, False), main._host(R, False)
    entry = spec.entry(cell.traffic["entry"])
    prog = entry.build(cell.config, "cpu")
    rec, _, _ = entry.run(prog, lefts, rights, cell.traffic, 1.0, 12)
    sound = entry.readings(cell.config, cell.traffic, rec, lefts, rights,
                           "cpu", 12)
    low = entry.readings(cell.config, cell.traffic, rec, lefts, rights,
                         "cpu", 12, control=True)
    assert check.judge(sound, cell.limits)[0]
    assert not check.judge(low, cell.limits)[0], low


@pytest.mark.parametrize("name", CELLS)
def test_a_step_that_returns_its_state_unchanged(monkeypatch, name):
    def change(step):
        def f(state, feats):
            _, ok, stats = step(state, feats)
            return state, ok, stats
        return f

    wrap_step(monkeypatch, change)
    out = run(name)
    assert not out["correct"] and out["checks"]["pose_gap"]["value"] > 0.1


@pytest.mark.parametrize("name", ["kitti-rig8.live", "kitti-stereo.replay"])
def test_half_of_the_batch_left_out(monkeypatch, name):
    """The rig's last cameras, or the stream's last frames of each chunk,
    keep their old state."""
    chunk = tiny(name).traffic.get("chunk", 1)
    calls = [0]

    def change(step):
        def f(state, feats):
            new, ok, stats = step(state, feats)
            if state.has_cur.ndim:   # a rig: cameras on the first axis
                h = state.has_cur.shape[0] // 2
                new = tree_map(lambda a, b: torch.cat([a[:h], b[h:]]), new,
                               state)
            else:
                calls[0] += 1
                if (calls[0] - 1) % chunk >= chunk // 2:
                    new = state
            return new, ok, stats
        return f

    wrap_step(monkeypatch, change)
    out = run(name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_a_pose_altered_where_it_is_produced(monkeypatch, name):
    import openvo_tpu_torch.models.stereo_odometer as so

    orig = so._compose

    def compose(a, b):
        out = orig(a, b)
        out[..., 0, 3] += 0.5
        return out

    monkeypatch.setattr(so, "_compose", compose)
    out = run(name)
    assert not out["correct"] and out["checks"]["pose_gap"]["value"] > 0.1


@pytest.mark.parametrize("name", CELLS)
def test_a_disparity_altered_where_it_is_produced(monkeypatch, name):
    import openvo_tpu_torch.models.stereo_camera as sc

    orig = sc.sgbm_disparity

    def disparity(left, right, params):
        d = orig(left, right, params).clone()
        d[..., ::8, :] += 1.0 / 16
        return d

    monkeypatch.setattr(sc, "sgbm_disparity", disparity)
    out = run(name)
    assert not out["correct"]
    assert out["checks"]["disp_mismatch"]["value"] > 0.05


@pytest.mark.parametrize("name", CELLS)
def test_one_step_gone_wrong_past_the_start(monkeypatch, name):
    """Every step is compared, not a sample: one pose altered on the first
    step after the fresh-state start (the rig's second camera) fails."""
    k = 3   # the start: two steps
    calls = [0]

    def change(step):
        def f(state, feats):
            new, ok, stats = step(state, feats)
            calls[0] += 1
            if calls[0] == k:
                pose = new.c_T_w.clone()
                (pose[-1] if pose.ndim == 3 else pose)[0, 3] += 0.5
                new = new._replace(c_T_w=pose)
            return new, ok, stats
        return f

    wrap_step(monkeypatch, change)
    out = run(name, start_steps=k - 1)
    assert not out["correct"] and out["checks"]["pose_gap"]["value"] > 0.1
