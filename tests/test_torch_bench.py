"""The port's benchmark entry point (``openvo_tpu_torch/tools/bench.py``)
on the CPU: a small run of two passes prints well-formed result lines and
a cumulative last line in ``bench.py``'s format, and the default run
refuses to start without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PASS_FIELDS = {"tag", "device", "timer", "frames", "work", "repeats",
               "ms_each", "ms_median", "ms_min", "ms_max", "spread", "fps", "fps_best",
               "warmup_s", "tracked", "skipped", "ate", "path_len",
               "repeats_agree", "peak_mib", "captured"}
LINE_FIELDS = {"metric", "value", "unit", "headline_shape", "tracked_frames",
               "total_frames", "ate_m", "ate_pct_of_path", "latency_fps",
               "stream_fps", "speckle_on_fps", "rig_fps", "card",
               "latency_warmup_s", "latency_ms_median", "latency_ms_min",
               "latency_spread", "latency_p50_ms", "latency_p90_ms",
               "latency_peak_mib", "stream_warmup_s", "stream_ms_median",
               "stream_ms_min", "stream_spread", "stream_peak_mib",
               "latency_captured", "stream_captured"}


def bench(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m",
                           "openvo_tpu_torch.tools.bench", *args],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=600)


def test_cpu_run_prints_well_formed_lines(tmp_path):
    proc = bench(["--device", "cpu", "--size", "320x240", "--frames", "4",
                  "--repeats", "1", "--passes", "off-lat,off-tp",
                  "--cache", str(tmp_path)], tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    results = [json.loads(x[len("PASS_RESULT "):]) for x in lines
               if x.startswith("PASS_RESULT ")]
    assert [r["tag"] for r in results] == ["off-lat", "off-tp"]
    for r in results:
        assert PASS_FIELDS <= set(r), PASS_FIELDS - set(r)
        assert r["device"] == "cpu" and r["frames"] == 4
        assert r["captured"] is False   # the CPU runs eagerly
        assert r["repeats_agree"] and r["tracked"] == 4
        assert r["skipped"] == []
        assert r["ms_min"] <= r["ms_median"] <= r["ms_max"]
        assert len(r["ms_each"]) == 1
    assert {"p50_ms", "p90_ms"} <= set(results[0])
    # a cumulative line after each pass, the last line the last of them
    cumulative = [json.loads(x) for x in lines if x.startswith("{")]
    assert len(cumulative) == 2 and lines[-1].startswith("{")
    last = cumulative[-1]
    assert LINE_FIELDS <= set(last), LINE_FIELDS - set(last)
    assert "vs_baseline" not in last and not any("compile" in k
                                                 for k in last)
    assert last["unit"].startswith("frames/sec (CPU")
    assert last["total_frames"] == 4 and last["tracked_frames"] == 4
    assert last["value"] == max(last["latency_fps"], last["stream_fps"])
    assert last["speckle_on_fps"] is None and last["rig_fps"] is None
    assert os.listdir(tmp_path) == ["corridor_320x240_4_r1.npz"]


def test_default_run_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = bench(["--frames", "2", "--cache", str(tmp_path)], tmp_path)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "PASS_RESULT" not in proc.stdout and os.listdir(tmp_path) == []
