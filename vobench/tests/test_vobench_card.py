"""On the card: a short run of each cell through the command, and no result
where the program is absent."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from vobench.tests.conftest import CELLS, ROOT


def command(cwd, name, trace=0):
    return subprocess.run(
        [sys.executable, "vobench/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=cwd)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_is_correct(card, name):
    out = command(ROOT, name)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_no_result_without_the_program(card, tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "vobench"), tmp_path / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(tmp_path, "kitti-stereo.live")
    assert out.returncode != 0 and out.stdout.strip() == ""
