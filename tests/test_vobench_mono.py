"""The benchmark's monocular cell on the CPU: the entry ``mono`` drives the
port's MonoOdometer over a small rendered corridor (320x240, 6 frames, 16
five-point samples a frame) with every SVD on the card's route
(``kabsch.card_svd_route``), and the plain reference
(``vobench/reference/mono.py``) is held to it step by step; the
reference's stream of uniforms is the port's; the reference imports
nothing of the program; the step places its stage marks in order; the
frame order shows no frame twice in a row."""

import ast
import copy
import pathlib

import numpy as np
import pytest
import torch

from openvo_tpu_torch.models import mono_odometer
from openvo_tpu_torch.pose import kabsch
from vobench.harness import render, spec
from vobench.harness.main import _host
from vobench.reference import mono as ref
from vobench.reference.odometry import ORB
from vobench.reference.orb import detect_and_compute

ROOT = pathlib.Path(__file__).resolve().parents[1]
FRAMES = 6
SEED = 2147483999
# c_T_w of the port against the reference: both run the same float32 and
# float64 operations in the same order on the same device, so they agree
# bit for bit; 1e-6 (m, and for the rotation's entries) is a few float32
# ulps of a pose 2.5 m out, room for nothing but a reordered sum.
POSE_TOL = 1e-6


@pytest.fixture(scope="module")
def cell():
    """kitti-mono.live at 320x240 (f 280 px), 64 RANSAC iterations (16
    five-point samples), 6 frames: 5 set-up steps and one window step."""
    c = spec.load("kitti-mono.live")
    cfg = copy.deepcopy(c.config)
    cfg["camera"].update(width=320, height=240, fx=280.0, fy=280.0,
                         cx=159.5, cy=119.5)
    cfg["mono"]["ransac_iters"] = 64
    c.config = cfg
    c.traffic = dict(c.traffic, motion=dict(c.traffic["motion"],
                                            frames=FRAMES),
                     setup_steps=FRAMES - 1, samples=2, start_steps=FRAMES,
                     check_steps=1)
    return c


@pytest.fixture(scope="module")
def run(cell):
    """(records, lefts) of the entry's run on the CPU."""
    L, R, _ = render.render_sequence(SEED, cell.config["camera"],
                                     cell.traffic["motion"], 1, "cpu")
    lefts, rights = _host(L, False), _host(R, False)
    entry = spec.entry("mono")
    prog = entry.build(cell.config, "cpu")
    with kabsch.card_svd_route():
        rec, _, _ = entry.run(prog, lefts, rights, cell.traffic, 0.0, SEED)
    return rec, lefts, rights


def test_reference_equals_the_port_step_by_step(cell, run):
    rec, lefts, _ = run
    assert rec.frame == list(range(FRAMES))
    p = ref.params(cell.config)
    assert p.samples == 16
    orb = ORB(**cell.config["orb"])
    feats = detect_and_compute(lefts[:, 0], None, orb)
    draws = ref.Draws(p.samples, "cpu")
    state = ref.initial_state("cpu")
    reached = 0
    for i, t in enumerate(rec.frame):
        frame = ref.Frame(feats["xy"][t], feats["desc"][t],
                          feats["valid"][t])
        state, out = ref.step(state, frame, draws.get(i),
                              cell.traffic["trans_scale"], p)
        assert bool(rec.success[i][0]) == out.accept
        assert int(rec.code[i][0]) == out.code
        assert int(rec.matches[i][0]) == out.matches
        assert rec.skipped[i] == state.skipped
        if out.inliers is not None:
            reached += 1
            assert rec.inliers[i] == out.inliers
        assert np.abs(rec.pose[i][0] - state.c_T_w.numpy()).max() <= POSE_TOL
    assert reached == FRAMES and all(s[0] for s in rec.success)


def test_the_check_reads_nothing_wrong(cell, run):
    rec, lefts, rights = run
    numbers = spec.entry("mono").readings(cell.config, cell.traffic, rec,
                                          lefts, rights, "cpu", SEED)
    assert numbers == {"kp_mismatch": 0.0, "matches_gap": 0,
                       "inliers_gap": 0, "pose_gap": 0.0}
    assert set(numbers) == set(cell.limits)


def test_reference_draws_the_ports_uniforms(monkeypatch):
    """The uniforms of 3 updates, as the port's step draws them from its
    state's generator, equal the reference's draws 0, 1, 2."""
    drawn = []
    real = mono_odometer.uniforms

    def spy(u, shape, device):
        drawn.append(real(u, shape, device))
        return drawn[-1]

    monkeypatch.setattr(mono_odometer, "uniforms", spy)
    K = render.intrinsics({"fx": 80.0, "fy": 80.0, "cx": 31.5, "cy": 23.5})
    odo = mono_odometer.MonoOdometer(K, ransac_iters=64, device="cpu")
    img = np.zeros((48, 64), np.uint8)
    for _ in range(3):
        odo.update(img, 0.5)
    draws = ref.Draws(16, "cpu")
    assert len(drawn) == 3
    for i, u in enumerate(drawn):
        assert torch.equal(u, draws.get(i))


def test_the_step_marks_its_stages_in_order(monkeypatch):
    seen = []
    monkeypatch.setattr(mono_odometer, "mark", seen.append)
    K = render.intrinsics({"fx": 80.0, "fy": 80.0, "cx": 31.5, "cy": 23.5})
    odo = mono_odometer.MonoOdometer(K, ransac_iters=64, device="cpu")
    odo.update(np.zeros((48, 64), np.uint8), 0.5)
    assert seen == ["start", "orb", "match", "ransac", "pose"]


def test_the_reference_imports_nothing_of_the_program():
    forbidden = {"jax", "jaxlib", "openvo_tpu", "openvo_tpu_torch"}
    files = sorted((ROOT / "vobench" / "reference").glob("*.py"))
    assert {"mono.py", "ransac.py", "fivepoint.py", "svd.py"} <= {
        f.name for f in files}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & forbidden, f.name


def test_frame_order_never_repeats_a_frame():
    frame_index = spec.entry("mono").frame_index
    order = [frame_index(i, 64) for i in range(3 * 126)]
    assert all(a != b for a, b in zip(order, order[1:]))
    assert order[:126] == list(range(64)) + list(range(62, 0, -1))
    assert order[126:252] == order[:126] and order[252:] == order[:126]


def test_the_cell_loads_by_name():
    cell = spec.load("kitti-mono.live")
    assert cell.chips == 1 and cell.config["cameras"] == 1
    assert cell.traffic["entry"] == "mono"
    names = {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert {"step_ms", "step_p95_ms", "setup_s", "ransac_dev_ms.live",
            "step_dev_ms.live", "capture_s"} <= names
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]).read)
    assert set(cell.limits) == {"kp_mismatch", "matches_gap", "inliers_gap",
                                "pose_gap"}
    assert cell.limits["kp_mismatch"] == 0 and cell.limits["matches_gap"] == 0


def test_the_essential_matrix_control_keeps_orb_exact(cell, run):
    """Control B (``control="ransac"``: the essential matrix's layer alone
    in lower precision) keeps ORB and the ratio test exact and still moves
    the inliers or the pose."""
    rec, lefts, rights = run
    numbers = spec.entry("mono").readings(cell.config, cell.traffic, rec,
                                          lefts, rights, "cpu", SEED,
                                          control="ransac")
    assert numbers["kp_mismatch"] == 0 and numbers["matches_gap"] == 0
    assert numbers["inliers_gap"] > 0 or numbers["pose_gap"] > 0
