"""BENCHMARK.json against the contract, and every file a cell names found
by name: configuration, traffic mix, limits, metric readers."""

import json
import math
import os
import re

import pytest

from vobench.harness import spec
from vobench.tests.conftest import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["vobench"] and b["command"][1] == "vobench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for x in b["configs"] + b["workloads"]
             + b["end_to_end"] + b["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("vobench/")
    assert {w["config"] for w in b["workloads"]} == configs
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            moved = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
            assert cell in moved.get("workloads", [cell])


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    cell = spec.load(name)
    assert cell.config["cameras"] >= 1
    assert callable(spec.entry(cell.traffic["entry"]).run)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]).read)
    numbers = {"disp_mismatch", "kp_mismatch", "pose_gap"}
    if cell.traffic["entry"] == "update":
        numbers.add("matches_gap")
    assert set(cell.limits) == numbers
    assert all(0 <= v and math.isfinite(v) for v in cell.limits.values())


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for name in CELLS:
        cell = spec.load(name)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.load("no-such.cell")


def test_traffic_files_say_what_the_harness_reads():
    """Every key of a mix is read: its entry, arrivals, motion, set-up,
    trace and check sizes (``about`` is its description)."""
    from vobench.harness import drive

    keys = {"name", "entry", "about", "arrivals", "motion", "setup_steps",
            "trace_steps", "samples", "start_steps", "check_cameras", "chunk"}
    for mix in ("live", "replay"):
        with open(os.path.join(ROOT, "vobench", "traffic",
                               f"{mix}.json")) as f:
            t = json.load(f)
        assert set(t) <= keys and t["name"] == mix
        drive.Arrivals(t["arrivals"])


def test_configurations_are_sequence_00():
    """Both cameras: KITTI odometry sequence 00's calibration (calib.txt
    P0, P1) at its image size."""
    for name in ("kitti-stereo", "kitti-rig8"):
        with open(os.path.join(ROOT, "vobench", "configs",
                               f"{name}.json")) as f:
            cam = json.load(f)["camera"]
        assert (cam["width"], cam["height"]) == (1241, 376)
        assert cam["fx"] == cam["fy"] == 718.856
        assert (cam["cx"], cam["cy"]) == (607.1928, 185.2157)
        assert cam["baseline_m"] == pytest.approx(386.1448 / 718.856,
                                                  abs=1e-7)


def test_configurations_are_the_programs_settings():
    """The configurations hold KITTI_SGBM, cv2.ORB's defaults in 512 slots
    and the odometer's defaults, as the program states them."""
    import dataclasses

    from openvo_tpu_torch import OdometerConfig, ORBParams
    from openvo_tpu_torch.io.kitti import KITTI_SGBM

    for name in ("kitti-stereo", "kitti-rig8"):
        with open(os.path.join(ROOT, "vobench", "configs",
                               f"{name}.json")) as f:
            c = json.load(f)
        assert c["sgbm"] == dataclasses.asdict(KITTI_SGBM)
        assert c["orb"] == dataclasses.asdict(ORBParams())
        odo = dict(c["odometer"])
        odo["max_rotation_change"] = math.pi / odo.pop(
            "max_rotation_change_pi_over")
        cfg = OdometerConfig(**odo)
        assert cfg == OdometerConfig()
