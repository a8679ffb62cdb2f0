"""A cell of ``BENCHMARK.json`` and the files it names, found by name:
``vobench/configs/<config>.json`` (through the configuration's ``file``),
``vobench/traffic/<mix>.json``, the entry ``vobench/entries/<entry>.py``
that the mix names, ``vobench/limits/<cell>.json`` and one reader
``vobench/metrics/<metric>.py`` for every metric of the cell."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "vobench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load(workload: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = _json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_path.name}: "
                       f"{sorted(cells)}")
    w = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=workload, chips=w["chips"],
        config=_json(ROOT / config["file"]),
        traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_json(HERE / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)])


def _module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"vobench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The module ``vobench/metrics/<name>.py``: ``read(ctx)`` gives the
    metric's value, or None where the run has nothing to read. ``ctx``
    holds ``cell``, ``config``, ``traffic``, ``records``
    (``drive.Records``), ``setup_s``, ``trace`` (``trace.Trace`` of the
    traced span, or None), ``events`` (the profiler's raw events, or
    None), ``layers`` (the entry's ``time_layers`` in a traced run on the
    card, or None), ``truth`` (the rendered (frames, 4, 4) poses),
    ``stats`` (the program's ``last_stats`` after the window, or None) and
    ``peak_bytes``."""
    return _module("metrics", name)


def entry(name: str):
    """The module ``vobench/entries/<name>.py`` that drives one API of the
    program: ``build(config, device)`` the program, ``run(program, lefts,
    rights, traffic, seconds, seed, trace_units)`` its set-up and window
    (records, profiler, handle), ``time_layers(program, traffic, lefts,
    rights)`` the layers alone after the window, and ``readings(config,
    traffic, records, lefts, rights, device, seed, control)`` the numbers
    held against the plain reference."""
    return _module("entries", name)
