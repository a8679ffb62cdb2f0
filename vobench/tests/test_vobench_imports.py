"""The harness loads neither JAX nor the JAX package, and without a card it
prints no result."""

import os
import shutil
import subprocess
import sys

from vobench.harness import main
from vobench.tests.conftest import ROOT

RUN = f"""
import sys
sys.path.insert(0, {ROOT!r})
from vobench.tests.conftest import tiny
from vobench.harness import main
main.run_cell(tiny("kitti-stereo.replay"), 3, 0.5, False, "cpu", 0.0)
print(main.forbidden_modules())
"""


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "openvo_tpu_torch.fake", None)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", None)
    base = main.forbidden_modules()
    assert "openvo_tpu" not in base and "jax" not in base
    monkeypatch.setitem(sys.modules, "openvo_tpu.ops", None)
    monkeypatch.setitem(sys.modules, "jax.numpy", None)
    assert {"openvo_tpu", "jax"} <= set(main.forbidden_modules())


def test_a_run_loads_no_jax_module():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", RUN], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def run_cmd(cwd):
    return subprocess.run(
        [sys.executable, "vobench/run.py", "--workload", "kitti-stereo.live",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_without_a_card_no_result():
    out = run_cmd(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "vobench"), tmp_path / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_cmd(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
