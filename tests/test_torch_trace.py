"""The port's trace (``openvo_tpu_torch/trace.py``) and the benchmark's
readers of it (``vobench/harness/program_trace.py``,
``vobench/metrics/*``).

On the CPU: recording off records nothing and hands out one null context;
an enabled odometer, rig and stream record their span trees (parents,
shared call ids, the fallback counter); the ring's bound and its dropped
count; the profiler's flag turning recording on, with no program span in
the profiler's events; every new reader on made-up records, and None
where there are none. On the card (marked ``cuda``): each replay's stage
marks read, the stages summing to the step and placed inside the host's
launch and wait on the host clock.
"""

import collections
import dataclasses
import types

import numpy as np
import pytest
import torch

import openvo_tpu_torch
from openvo_tpu_torch import trace
from openvo_tpu_torch.io.synthetic import render_stereo_sequence
from openvo_tpu_torch.parallel.rig import RigOdometer
from openvo_tpu_torch.parallel.stream import make_stream_fn
from openvo_tpu_torch.models.stereo_odometer import init_state
from vobench.harness import program_trace, spec

IMG_SIZE = (160, 120)
SGBM = {"minDisparity": 0, "numDisparities": 32, "blockSize": 5,
        "P1": 200, "P2": 800, "disp12MaxDiff": 1, "preFilterCap": 63,
        "uniquenessRatio": 10, "speckleWindowSize": 0, "speckleRange": 0}
CHILDREN = {
    "ovo.update": ["ovo.prepare", "ovo.upload", "ovo.launch", "ovo.wait",
                   "ovo.unpack"],
    "ovo.stream": ["ovo.upload", "ovo.launch", "ovo.unpack"],
}
STAGES = ["depth", "orb", "match", "pose", "state", "state"]


@pytest.fixture(autouse=True)
def fresh_trace():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


@pytest.fixture(scope="module")
def seq():
    return render_stereo_sequence(n_frames=4, img_size=IMG_SIZE, f=140.0,
                                  baseline=0.5, seed=0, step=0.3,
                                  yaw_rate=0.006)


def frames(seq, n, side):
    return np.clip(seq[side][:n], 0, 255).astype(np.uint8)


def camera(seq, device):
    return openvo_tpu_torch.StereoCamera(
        seq["K"], seq["dist"], seq["K"], seq["dist"],
        {"R": seq["R"], "T": seq["T"]}, SGBM, IMG_SIZE, device=device)


@pytest.fixture(scope="module")
def cpu_cam(seq):
    return camera(seq, "cpu")


def run(kind, cam, seq, calls=2, chunks=1):
    """``calls`` calls of a 2-camera rig (2 frames a call) or of a stream
    of 2-frame chunks (``chunks`` a call), or the odometer (``stereo``)
    on frames 0, 1, ... (for 4 calls: 0, 1, an unrelated frame, 2)."""
    lefts, rights = frames(seq, 4, "left"), frames(seq, 4, "right")
    if kind == "stereo":
        odo = openvo_tpu_torch.StereoOdometer(cam)
        if calls == 4:
            other = render_stereo_sequence(n_frames=1, img_size=IMG_SIZE,
                                           f=140.0, baseline=0.5, seed=7)
            lefts = [lefts[0], lefts[1], frames(other, 1, "left")[0],
                     lefts[2]]
            rights = [rights[0], rights[1], frames(other, 1, "right")[0],
                      rights[2]]
        for i in range(calls):
            odo.update(lefts[i], rights[i])
        return odo
    if kind == "rig":
        rig = RigOdometer(cam, 2)
        for i in range(calls):
            rig.update(lefts[i:i + 2], rights[i:i + 2])
        return rig
    stream = make_stream_fn(cam, openvo_tpu_torch.OdometerConfig(), chunk=2)
    state = init_state(cam.cropped_shape, 512, cam.device)
    n = 2 * chunks
    for i in range(calls):
        state, _ = stream(state, lefts[:n], rights[:n])
    return stream


@pytest.fixture(scope="module")
def cpu_records(seq, cpu_cam):
    """The records of each kind's CPU run with recording on, and (for
    ``off``) of the first odometer run's first call with it off."""
    out = {}
    for kind in ["stereo", "rig", "stream"]:
        trace.clear()
        trace.enable()
        run(kind, cpu_cam, seq, calls=4 if kind == "stereo" else 2)
        trace.disable()
        out[kind] = trace.records()
    trace.clear()
    odo = openvo_tpu_torch.StereoOdometer(cpu_cam)
    odo.update(frames(seq, 1, "left")[0], frames(seq, 1, "right")[0])
    out["off"] = trace.records()
    trace.clear()
    return out


def test_recording_off_records_nothing(cpu_records):
    assert not trace.recording()
    assert trace.span("ovo.a") is trace.span("ovo.b")
    with trace.span("ovo.a") as s:
        assert s is None
        trace.count("ovo.fallback", 3)
    assert trace.records() == [] and trace.dropped() == 0
    assert cpu_records["off"] == []
    with trace.span("ovo.capture", always=True):
        pass
    assert [r.name for r in trace.records()] == ["ovo.capture"]


@pytest.mark.parametrize("kind", ["stereo", "rig", "stream"])
def test_calls_record_their_span_trees(cpu_records, kind):
    """Each call is one tree: its outermost span at the top (parent -1,
    its own id the call), its children in order and inside it, every
    record of the call sharing the call's id; the odometers count the
    fallback once a call, in their unpack span."""
    recs = cpu_records[kind]
    top = "ovo.stream" if kind == "stream" else "ovo.update"
    roots = [r for r in recs if r.parent == -1]
    assert [r.name for r in roots] == [top] * (4 if kind == "stereo" else 2)
    assert len({r.call for r in roots}) == len(roots)
    by_id = {r.id: r for r in recs}
    for root in roots:
        assert root.call == root.id
        mine = [r for r in recs if r.call == root.id and r is not root]
        kids = sorted((r for r in mine if r.parent == root.id),
                      key=lambda r: r.start)
        spans = [r for r in kids if r.start < r.end]
        assert [r.name for r in spans] == CHILDREN[top]
        for a, b in zip(spans, spans[1:]):
            assert a.end <= b.start
        for r in mine:
            parent = by_id[r.parent]
            assert parent.start <= r.start <= r.end <= parent.end
        fallback = [r for r in mine if r.name == "ovo.fallback"]
        if kind == "stream":
            assert not fallback
        else:
            assert len(fallback) == 1
            assert by_id[fallback[0].parent].name == "ovo.unpack"
            assert 0 <= fallback[0].n <= (2 if kind == "rig" else 1)
    assert not any(r.name.startswith("dev.") for r in recs)   # no card


def test_fallback_counts_the_steps_that_took_attempt_2(cpu_records):
    """The counter is the sum of the update's ``use2`` row: the first two
    frames have no frame before last; the third, unrelated to the
    second, fails attempt 1, so the fallback's result (against the first)
    is taken; the fourth tracks against the second by attempt 1."""
    counts = [r.n for r in cpu_records["stereo"] if r.name == "ovo.fallback"]
    assert counts == [0, 0, 1, 0]


def test_ring_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(trace._T, "ring", collections.deque(maxlen=8))
    trace.enable()
    for i in range(20):
        trace.count("ovo.fallback", i)
    recs = trace.records()
    assert [r.n for r in recs] == list(range(12, 20))
    assert trace.dropped() == 12
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0


def test_the_profiler_turns_recording_on():
    """Recording follows the profiler's flag, and the program's spans
    are not profiler ranges: the profiler's events hold none of them."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        assert trace.recording()
        with trace.span("ovo.update"):
            torch.ones(3).sum()
    assert not trace.recording()
    with trace.span("ovo.update"):
        pass
    assert [r.name for r in trace.records()] == ["ovo.update"]
    assert not any(e.name.startswith("ovo.") for e in prof.events())


# -- the readers, on made-up records -----------------------------------------

MS = 1_000_000   # ns


def made_up(units, chunk_frames=1, t0=10 * 10 ** 9):
    """Records of ``units`` calls 5 ms apart, each: an update (stream) span
    over [0.2, 4.8] ms, its graph on the device from 1 ms with stages
    depth 1, orb 0.5, then match 0.1, pose 0.2, state 0.2 a frame, then
    state 0.2 again; a fallback counter of 1 in every other call; and a
    capture of 6 ms before the window."""
    Rec = trace.Record
    out = [Rec("ovo.capture", t0 - 9 * MS, t0 - 3 * MS, 0, -1, 0)]
    rid = 1
    for u in range(units):
        b = t0 + u * 5 * MS
        out.append(Rec("ovo.update", b + MS // 5, b + 24 * MS // 5, rid, -1,
                       rid))
        call = rid
        seg = [("depth", MS), ("orb", MS // 2)]
        seg += [("match", MS // 10), ("pose", MS // 5),
                ("state", MS // 5)] * chunk_frames
        seg.append(("state", MS // 5))
        t = b + MS
        end = t + sum(d for _, d in seg)
        step = Rec("dev.step", t, end, rid + 1, rid, call)
        out.append(step)
        rid += 2
        for name, d in seg:
            out.append(Rec("dev." + name, t, t + d, rid, step.id, call))
            t, rid = t + d, rid + 1
        out.append(Rec("ovo.fallback", end, end, rid, call, call, u % 2))
        rid += 1
    return out


def ctx_for(recs, cell, units, t0=10.0, frames_per_unit=1):
    return types.SimpleNamespace(
        records=types.SimpleNamespace(window_start=t0,
                                      window_s=units * 0.005,
                                      window_steps=units,
                                      window_frames=units * frames_per_unit),
        config={"cameras": 2}, traffic={"chunk": frames_per_unit},
        cell=cell)


def read(name, ctx):
    return spec.reader(name).read(ctx)


@pytest.fixture
def fake_records(monkeypatch):
    made = []
    monkeypatch.setattr(trace, "records", lambda: list(made))
    return made


def test_live_readers_on_made_up_records(fake_records):
    fake_records += made_up(4)
    ctx = ctx_for(fake_records, "kitti-stereo.live", 4)
    got = {m: read(m, ctx) for m in
           ["step_dev_ms.live", "depth_dev_ms.live", "orb_dev_ms.live",
            "match_dev_ms.live", "pose_dev_ms.live", "state_dev_ms.live",
            "host_ms.live", "fallback_share.live", "capture_s"]}
    assert got["step_dev_ms.live"] == pytest.approx(2.2)
    assert got["depth_dev_ms.live"] == pytest.approx(1.0)
    assert got["orb_dev_ms.live"] == pytest.approx(0.5)
    assert got["match_dev_ms.live"] == pytest.approx(0.1)
    assert got["pose_dev_ms.live"] == pytest.approx(0.2)
    assert got["state_dev_ms.live"] == pytest.approx(0.4)
    assert sum(got[f"{s}_dev_ms.live"] for s in
               ["depth", "orb", "match", "pose", "state"]) == pytest.approx(
                   got["step_dev_ms.live"])
    # graph end 3.2 ms to the next start 6 ms: the spans cover [3.2, 4.8]
    # and [5.2, 6]
    assert got["host_ms.live"] == pytest.approx(2.4)
    # 2 of the 4 calls took the fallback, 2 cameras each
    assert got["fallback_share.live"] == pytest.approx(25.0)
    assert got["capture_s"] == pytest.approx(0.006)


def test_replay_readers_on_made_up_records(fake_records):
    fake_records += made_up(3, chunk_frames=4)
    ctx = ctx_for(fake_records, "kitti-stereo.replay", 3, frames_per_unit=4)
    # a chunk's graph: 1 + 0.5 + 4 x 0.5 + 0.2 = 3.7 ms over 4 frames
    assert read("step_dev_ms.replay", ctx) == pytest.approx(0.925)
    assert read("depth_dev_ms.replay", ctx) == pytest.approx(0.25)
    assert read("orb_dev_ms.replay", ctx) == pytest.approx(0.125)
    assert read("match_dev_ms.replay", ctx) == pytest.approx(0.1)
    assert read("pose_dev_ms.replay", ctx) == pytest.approx(0.2)
    assert read("state_dev_ms.replay", ctx) == pytest.approx(0.25)
    # graph end 4.7 ms to the next start 6 ms: spans cover [4.7, 4.8]
    # and [5.2, 6]
    assert read("host_ms.replay", ctx) == pytest.approx(0.9 / 4)


def test_readers_find_nothing_without_records(fake_records):
    """No records (as on a checkout whose program keeps no trace): every
    new reader reads None; records outside the window are not read."""
    names = [f"{s}_dev_ms.{k}" for s in
             ["step", "depth", "orb", "match", "pose", "state"]
             for k in ["live", "replay"]]
    names += ["host_ms.live", "host_ms.replay", "fallback_share.live",
              "capture_s"]
    ctx = ctx_for(fake_records, "kitti-stereo.live", 4)
    assert {n: read(n, ctx) for n in names} == {n: None for n in names}
    fake_records += made_up(4, t0=20 * 10 ** 9)   # after the window
    assert read("step_dev_ms.live", ctx) is None
    assert read("fallback_share.live", ctx) is None
    assert program_trace.window_records(ctx) == []


def test_new_metrics_are_declared_with_their_readers():
    """Every new per-layer metric of BENCHMARK.json has its reader, and a
    cell that lists it loads it."""
    cell = spec.load("kitti-stereo.replay")
    names = {m["name"] for m in cell.per_layer}
    assert {"step_dev_ms.replay", "host_ms.replay", "capture_s"} <= names
    assert "fallback_share.live" not in names
    live = {m["name"] for m in spec.load("kitti-rig8.live").per_layer}
    assert {"fallback_share.live", "state_dev_ms.live", "capture_s"} <= live
    for n in names | live:
        assert callable(spec.reader(n).read)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["stereo", "rig", "stream"])
def test_card_marks_sum_to_the_step_inside_launch_and_wait(seq, cuda, kind):
    """Captured on the card, each traced replay gives one ``dev.step``
    inside its ``ovo.launch`` span's call: the stages in the graph's
    order, summing to the step (ns rounding aside), the graph's start
    after its launch began and (for the odometers) its end before the
    sync returned. A stream call of 2 chunks replays its graph twice,
    reading the first replay's marks before the second."""
    trace.enable()
    run(kind, camera(seq, cuda), seq, calls=2, chunks=2)
    recs = trace.records()
    by_id = {r.id: r for r in recs}
    steps = [r for r in recs if r.name == "dev.step"]
    assert len(steps) == 4 if kind == "stream" else 2
    stages = (["depth", "orb"] + ["match", "pose", "state"] * 2 + ["state"]
              if kind == "stream" else STAGES)
    for s in steps:
        segs = sorted((r for r in recs if r.parent == s.id),
                      key=lambda r: r.start)
        assert [r.name[4:] for r in segs] == stages
        assert segs[0].start == s.start and segs[-1].end == s.end
        for a, b in zip(segs, segs[1:]):
            assert a.end == b.start
        launch = by_id[s.parent]
        assert launch.name == "ovo.launch" and s.call == launch.call
        assert s.start >= launch.start
        wait = [r for r in recs if r.name == "ovo.wait" and r.call == s.call]
        if kind != "stream":
            assert s.end <= wait[0].end


@pytest.mark.cuda
@pytest.mark.parametrize("kind,changes,per_step", [
    ("stereo", {}, 1), ("rig", {}, 1), ("stream", {}, 1),
    ("rig", dict(num_paths=8), 2), ("rig", dict(num_paths=4), 1),
    ("rig", dict(block_size=13, p1=8 * 169, p2=32 * 169), 3)],
    ids=["stereo", "rig", "stream", "rig-hh8", "rig-hv4", "rig-block13"])
def test_card_captured_steps_count_their_vsweep_design(seq, cuda, kind,
                                                       changes, per_step):
    """The H2 launches of each path's step while it is captured (its
    warm-up and its capture), by trace counter: the int16 trio of 4 frames
    (a rig of 4 cameras, a stream of 4-frame chunks; 8 paths: down, then
    up) as ``ovo.vsweep_trio`` only, the straight lines (4 paths) and
    float32 C (block 13) and a single frame (stereo) as ``ovo.vsweep``
    only."""
    from openvo_tpu_torch.models.stereo_camera import _sgbm_params_from_dict

    params = dataclasses.replace(_sgbm_params_from_dict(SGBM), **changes)
    cam = openvo_tpu_torch.StereoCamera(
        seq["K"], seq["dist"], seq["K"], seq["dist"],
        {"R": seq["R"], "T": seq["T"]}, params, IMG_SIZE, device=cuda)
    lefts, rights = frames(seq, 4, "left"), frames(seq, 4, "right")
    trace.enable()
    if kind == "stereo":
        odo = openvo_tpu_torch.StereoOdometer(cam)
        for i in range(2):
            odo.update(lefts[i], rights[i])
    elif kind == "rig":
        rig = RigOdometer(cam, 4)
        for _ in range(2):
            rig.update(lefts, rights)
    else:
        stream = make_stream_fn(cam, openvo_tpu_torch.OdometerConfig(),
                                chunk=4)
        state = init_state(cam.cropped_shape, 512, cam.device)
        for _ in range(2):
            state, _ = stream(state, lefts, rights)
    counts = collections.Counter()
    for r in trace.records():
        if r.name in ("ovo.vsweep", "ovo.vsweep_trio"):
            counts[r.name] += r.n
    trio = (params.num_paths != 4 and params.block_size == 5
            and kind != "stereo")
    name = "ovo.vsweep_trio" if trio else "ovo.vsweep"
    assert counts[name] > 0 and counts[name] % per_step == 0
    assert sum(counts.values()) == counts[name]


@pytest.mark.cuda
def test_card_mono_marks_sum_to_the_step(seq, cuda):
    """A captured MonoOdometer update, replayed 3 times: each replay gives
    one ``dev.step`` inside its ``ovo.launch`` span's call and before the
    sync returned, with the stages ``orb``, ``match``, ``ransac``,
    ``pose``, ``state`` in the graph's order, summing to the step within
    5%."""
    from openvo_tpu_torch.models.mono_odometer import MonoOdometer

    odo = MonoOdometer(seq["K"], device=cuda)
    trace.enable()
    for img in frames(seq, 3, "left"):
        odo.update(img, 0.3)
    assert odo.captured
    recs = trace.records()
    by_id = {r.id: r for r in recs}
    steps = [r for r in recs if r.name == "dev.step"]
    assert len(steps) == 3
    for s in steps:
        segs = sorted((r for r in recs if r.parent == s.id),
                      key=lambda r: r.start)
        assert [r.name[4:] for r in segs] == ["orb", "match", "ransac",
                                              "pose", "state"]
        total = sum(r.end - r.start for r in segs)
        assert abs(total - (s.end - s.start)) <= 0.05 * (s.end - s.start)
        launch = by_id[s.parent]
        assert launch.name == "ovo.launch" and s.call == launch.call
        wait = [r for r in recs if r.name == "ovo.wait" and r.call == s.call]
        assert s.start >= launch.start and s.end <= wait[0].end


@pytest.mark.cuda
def test_card_capture_warms_up_on_the_replays_stream(cuda):
    """The capture's warm-up runs eagerly on the caller's current stream,
    the one the replays run on (a step's kernels on a side stream leave
    every later kernel of the process slower on the card for seconds);
    the capture itself runs on a stream of its own."""
    from openvo_tpu_torch import _graph

    seen = []

    def fn(state, x):
        seen.append(torch.cuda.current_stream())
        return (), x * 2

    step = _graph.capture(fn, device=cuda)
    x = torch.ones(4, device=cuda)
    for _ in range(2):
        _, y = step((), x)
    torch.cuda.synchronize()
    assert len(seen) == 2   # the warm-up and the capture, then replays
    assert seen[0] == torch.cuda.current_stream()
    assert seen[1] != torch.cuda.current_stream()
    assert torch.equal(y, x * 2)
