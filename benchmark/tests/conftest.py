"""Shared helpers of the benchmark's own tests (run them with
``python -m pytest benchmark/tests``; they import no JAX)."""

from __future__ import annotations

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# sizes at which the program's CPU path runs a cell in seconds
TINY = {
    "survey.solve": {"cams": 96, "lines_per_cam": 3, "max_iters": 10,
                     "cg_iters": 40},
}
TINY_TRAFFIC = {"survey.solve": {"maps": 2, "checked_maps": 1}}


def tiny_cell(name):
    """The cell ``name`` cut to a size the CPU runs quickly."""
    from benchmark.harness.spec import load_cell
    cell = copy.deepcopy(load_cell(name))
    cell.config.update(TINY[name])
    cell.traffic.update(TINY_TRAFFIC.get(name, {}))
    return cell


def run_tiny(cell, seed=3, seconds=0.0):
    import time

    import torch
    from benchmark import run
    result, lines = run.run_cell(cell, seed, seconds, False,
                                 torch.device("cpu"),
                                 log=lambda *a: None,
                                 t_start=time.perf_counter())
    return result


@pytest.fixture
def cpu_only():
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)
