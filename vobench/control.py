"""Readings that set the limits of ``correct``: for each seed, a short
window of a cell at its own size, then the numbers compared for the
program (the lower readings) and for the control, the plain reference in
lower precision in the program's place (the upper readings). The
benchmark's own runs do not run this.

    python3 vobench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 3] [--no-control]

One JSON line a seed: {"seed", "program": {...}, "control": {...}}; the
last line the largest program reading and the smallest control reading of
each number.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from vobench.harness import render, spec  # noqa: E402
from vobench.harness.main import _host  # noqa: E402


def readings(cell, seed, seconds, device, prog, control=True):
    cfg, traffic = cell.config, cell.traffic
    entry = spec.entry(traffic["entry"])
    L, R, _ = render.render_sequence(seed, cfg["camera"], traffic["motion"],
                                     cfg["cameras"], device)
    pinned = torch.device(device).type == "cuda"
    lefts, rights = _host(L, pinned), _host(R, pinned)
    del L, R
    rec, _, handle = entry.run(prog, lefts, rights, traffic, seconds, seed)
    del handle
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    out = {"seed": seed, "steps": len(rec.frame),
           "program": entry.readings(cfg, traffic, rec, lefts, rights,
                                     device, seed, log=log)}
    if control:
        out["control"] = entry.readings(cfg, traffic, rec, lefts, rights,
                                        device, seed, control=True, log=log)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--no-control", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load(args.workload)
    prog = spec.entry(cell.traffic["entry"]).build(cell.config, "cuda")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rows.append(readings(cell, seed, args.seconds, "cuda", prog,
                             not args.no_control))
        rows[-1]["s"] = time.perf_counter() - t0
        print(json.dumps(rows[-1]), flush=True)
    names = rows[0]["program"]
    summary = {"workload": cell.name,
               "program_max": {k: max(r["program"][k] for r in rows)
                               for k in names}}
    if not args.no_control:
        summary["control_min"] = {k: min(r["control"][k] for r in rows)
                                  for k in names}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
