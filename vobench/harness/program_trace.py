"""The program's own trace (``openvo_tpu_torch.trace``) as the per-layer
metrics read it: the device's stage times a unit, the host's time between
two units' graphs, the set-up's captures and the fallback's share. The
records are on the host clock (``perf_counter_ns``), as the window's are.

Every reading is None where the program keeps no such trace (a checkout
without ``openvo_tpu_torch/trace.py``) or recorded nothing to read."""

from __future__ import annotations


def all_records() -> list:
    """The program's records, or [] where it keeps none."""
    try:
        from openvo_tpu_torch import trace
    except ImportError:
        return []
    return trace.records()


def window_records(ctx) -> list:
    """The records that began within the window."""
    r = ctx.records
    t0, t1 = r.window_start * 1e9, (r.window_start + r.window_s) * 1e9
    return [x for x in all_records() if t0 <= x.start <= t1]


def _per(ctx, units: int, per_frame: bool) -> float:
    """The denominator: graph replays, or their frames (a chunk each)."""
    return units * (ctx.traffic["chunk"] if per_frame else 1)


def device_ms(ctx, stage: str, per_frame: bool = False):
    """ms of the device's ``stage`` (``step``: the whole graph, from its
    ``start`` mark to its last) a replay, or a frame."""
    recs = window_records(ctx)
    steps = sum(x.name == "dev.step" for x in recs)
    segs = [x.end - x.start for x in recs if x.name == "dev." + stage]
    if not steps or not segs:
        return None
    return 1e-6 * sum(segs) / _per(ctx, steps, per_frame)


def _union(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def host_ms(ctx, per_frame: bool = False):
    """ms a replay (or a frame) of the time between one graph's end and the
    next one's start that lies under the program's spans: the program's
    host work between two units (the rest is the caller's)."""
    recs = window_records(ctx)
    steps = sorted((x.start, x.end) for x in recs if x.name == "dev.step")
    if len(steps) < 2:
        return None
    spans = _union((x.start, x.end) for x in recs
                   if x.name.startswith("ovo.") and x.end > x.start)
    under = 0
    for (_, a), (b, _) in zip(steps, steps[1:]):
        for s, e in spans:
            under += max(0, min(b, e) - max(a, s))
    return 1e-6 * under / _per(ctx, len(steps) - 1, per_frame)


def capture_s(ctx):
    """Seconds of the graphs' warm-ups and captures (``ovo.capture``)
    that ended before the window."""
    t0 = ctx.records.window_start * 1e9
    caps = [x.end - x.start for x in all_records()
            if x.name == "ovo.capture" and x.end <= t0]
    return 1e-9 * sum(caps) if caps else None


def fallback_share(ctx):
    """% of the window's camera-steps that took the fallback's result
    (``ovo.fallback``, counted once an update)."""
    counts = [x.n for x in window_records(ctx) if x.name == "ovo.fallback"]
    if not counts:
        return None
    return 100.0 * sum(counts) / (len(counts) * ctx.config["cameras"])
