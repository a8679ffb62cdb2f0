"""Shared pieces of the benchmark's tests: the card marker and fixture, and
each cell cut to a size the CPU runs in seconds (its plain versions)."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELLS = ("kitti-stereo.live", "kitti-rig8.live", "kitti-stereo.replay")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skipped where none is present)")


@pytest.fixture
def card():
    """Skips the test where torch finds no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def tiny(name: str):
    """The cell ``name`` at 191x96 with 32 disparities (two cameras for a
    rig, chunks of 4 for the stream), two samples, two traced units and
    the first 6 steps run from the fresh state."""
    from vobench.harness import spec

    cell = spec.load(name)
    c = copy.deepcopy(cell.config)
    c["camera"].update(width=191, height=96, fx=111.0, fy=111.0, cx=93.7,
                       cy=47.3)
    c["sgbm"]["num_disparities"] = 32
    c["cameras"] = min(c["cameras"], 2)
    cell.config = c
    cell.traffic = dict(cell.traffic, samples=2, trace_steps=2,
                        start_steps=6)
    if cell.traffic["entry"] == "stream":
        cell.traffic["chunk"] = 4
    return cell
