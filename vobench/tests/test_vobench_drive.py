"""The window and its arrival processes, and the entries found by name."""

import time

import pytest

from vobench.harness import drive, spec


def test_entries_load_by_name():
    for name in ("update", "stream"):
        e = spec.entry(name)
        for fn in ("build", "run", "time_layers", "readings"):
            assert callable(getattr(e, fn)), (name, fn)
    with pytest.raises(KeyError):
        spec.entry("no-such-entry")


def window(arrivals, unit_s, seconds=0.3):
    rec = drive.Records()
    ran = []

    def unit(i):
        ran.append((i, time.perf_counter()))
        time.sleep(unit_s)

    end, _ = drive.window(rec, unit, lambda i: None, 5, seconds,
                          {"arrivals": arrivals}, 0, "cpu")
    return rec, ran, end


def test_a_closed_loop_runs_back_to_back():
    rec, ran, end = window("closed", 0.01)
    assert end == 5 + rec.window_steps and ran[0][0] == 5
    assert rec.window_steps == len(rec.latency_s) == len(ran)
    assert rec.window_s >= 0.3 and 20 <= rec.window_steps <= 31
    assert min(rec.latency_s) >= 0.01


def test_a_rate_paces_arrivals_and_counts_the_wait():
    rec, ran, _ = window({"rate_hz": 50}, 0.001)
    gaps = [b[1] - a[1] for a, b in zip(ran, ran[1:])]
    assert min(gaps) >= 0.015 and 14 <= rec.window_steps <= 17
    assert max(rec.latency_s) < 0.015
    # a unit slower than the period: the queue grows, latency with it
    rec, _, _ = window({"rate_hz": 200}, 0.01)
    assert rec.latency_s[-1] > rec.latency_s[0] + 0.1


def test_unknown_arrivals_are_refused():
    with pytest.raises(ValueError):
        drive.Arrivals({"rate": 10})
