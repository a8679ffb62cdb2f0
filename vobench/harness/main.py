"""One run of one cell: make the inputs from the seed, set the program up,
measure the window, read the trace where asked, hold what the timed path
produced against the plain reference, print the result line."""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

from vobench.harness import check, render, spec
from vobench.harness import trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "openvo_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the port must not load
    (the whole name before the first dot: ``openvo_tpu_torch`` passes)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _card_state() -> str:
    """The card's clocks, power, temperature and power limit (nvidia-smi;
    read only)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
             "temperature.gpu,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"
    return out.stdout.strip().replace("\n", "; ")


def _host(x: torch.Tensor, pinned: bool) -> torch.Tensor:
    """(cameras, frames, H, W) on the device -> (frames, cameras, H, W) in
    host memory, pinned on the card, where a camera delivers its frames."""
    x = x.transpose(0, 1).contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=pinned)
    return out.copy_(x)


def _proc(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def host_state() -> dict:
    """The process's CPU placement and the host's CPU time stolen so far
    (read from /proc; nothing is set): the CPUs it may run on, the one it
    last ran on and that CPU's clock, its context switches, and the host's
    steal and total jiffies."""
    stat = _proc("/proc/self/stat")
    cpu = int(stat.rsplit(")", 1)[1].split()[36]) if stat else -1
    mhz = [line.split(":")[1].strip() for line in
           _proc("/proc/cpuinfo").splitlines() if line.startswith("cpu MHz")]
    status = dict(line.split(":", 1) for line in
                  _proc("/proc/self/status").splitlines() if ":" in line)
    total = [int(v) for v in (_proc("/proc/stat").splitlines() or ["x"])[0]
             .split()[1:]]
    return {"affinity": sorted(os.sched_getaffinity(0)), "cpu": cpu,
            "mhz": mhz[cpu] if 0 <= cpu < len(mhz) else None,
            "switches": [status.get(k, "").strip() for k in
                         ("voluntary_ctxt_switches",
                          "nonvoluntary_ctxt_switches")],
            "steal": total[7] if len(total) > 7 else None,
            "jiffies": sum(total)}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> dict:
    """The result of one run (the line's object, ``checks`` last)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    config, traffic = cell.config, cell.traffic
    if cuda:   # the reference's float32 products stay float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    L, R, truth = render.render_sequence(seed, config["camera"],
                                     traffic["motion"], config["cameras"],
                                     dev)
    lefts, rights = _host(L, cuda), _host(R, cuda)
    del L, R
    t_inputs = time.perf_counter()
    if cuda:   # the peak is the program's, not the renderer's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    entry = spec.entry(traffic["entry"])
    prog = entry.build(config, dev)
    t_program = time.perf_counter()
    card = _card_state() if cuda else None
    host = host_state()
    rec, prof, handle = entry.run(prog, lefts, rights, traffic, seconds,
                                  seed, traffic["trace_steps"] if trace
                                  else 0)
    if cuda:
        log(f"[{cell.name}] card (sm MHz, mem MHz, W, C, limit W) before "
            f"set-up {card}, after the window {_card_state()}")
    log(f"[{cell.name}] host at the program's first call {host}, after "
        f"the window {host_state()}")
    setup_s = rec.window_start - t_start
    log(f"[{cell.name}] set-up: to the inputs on the host "
        f"{t_inputs - t_start:.2f} s (imports, render), the program "
        f"{t_program - t_inputs:.2f} s, its first calls "
        f"{[round(x, 3) for x in rec.setup_step_s]} s")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    tr = trace_mod.read(prof) if prof is not None else None
    events = prof.events() if prof is not None else None
    stats = getattr(handle, "last_stats", None)
    del prof
    timings = None
    if trace and cuda:
        timings = entry.time_layers(prog, traffic, lefts, rights)
    del handle, prog
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = entry.readings(config, traffic, rec, lefts, rights, dev, seed,
                             log=log)
    log(f"[{cell.name}] seed {seed}: set-up {setup_s:.2f} s, window "
        f"{rec.window_s:.2f} s of {rec.window_steps} calls, reference "
        f"{time.perf_counter() - t_ref:.2f} s, "
        f"peak {peak / 2 ** 30:.2f} GiB (reference "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else 0:.2f})")
    correct, table = check.judge(numbers, cell.limits)
    # what a metric's reader may read (``vobench/metrics/<name>.py``)
    ctx = types.SimpleNamespace(cell=cell, config=config, traffic=traffic,
                                records=rec, setup_s=setup_s, trace=tr,
                                events=events, layers=timings, truth=truth,
                                stats=stats, peak_bytes=peak)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = spec.reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    window = slice(rec.setup_steps, None)
    untracked = int(sum((~s).sum() for s in rec.success[window]))
    missed = [(i, rec.frame[i], int(rec.code[i][c]))
              for i in range(len(rec.success))
              for c in np.nonzero(~rec.success[i])[0]]
    if rec.latency_s:
        q = np.percentile(np.asarray(rec.latency_s) * 1e3, [5, 50, 95, 99])
        log(f"[{cell.name}] unit latency ms p5 {q[0]:.3f} p50 {q[1]:.3f} "
            f"p95 {q[2]:.3f} p99 {q[3]:.3f}")
    log(f"[{cell.name}] {untracked} of {rec.window_frames} frames of the "
        f"window untracked (the odometer's skips; the reference line above "
        f"says which cameras' steps it compared); (row, frame, skip code) "
        f"of the first: {missed[:12]}")
    info = {"platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(peak)}
    # every frame offered got its answer; a skip is an answer, judged above
    out = {"correct": bool(correct), "attempted": int(rec.window_frames),
           "failed": 0, "metrics": metrics, "device": info}
    if tr is not None:
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops,
                            "idle_gaps": tr.idle_gaps}
    out["checks"] = table
    return out


def parse(argv):
    p = argparse.ArgumentParser(description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"vobench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_start)
    found = forbidden_modules()
    if found:
        print(f"vobench: modules loaded that the port must not load: "
              f"{found}", file=sys.stderr)
        return 3
    for name, e in out["checks"].items():
        print(f"check {name}: {e['value']!r} (limit {e['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
