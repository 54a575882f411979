"""The survey cell's control comes out as not correct on the card, and
the program at the same size as correct: the reference put in the
program's place, in float32 with TF32 products, at 2048 cameras with 8
lines each and one map (the cell's own size is calibrate.py's, on the
card).  Run on the card with
``python -m pytest benchmark/tests/test_bench_control.py -o addopts=``;
it skips where there is no card."""

from __future__ import annotations

import time

import pytest

from benchmark import run
from benchmark.harness.spec import load_cell


def _cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the program's kernels run only "
                    "on the card")
    return torch.device("cuda", 0)


def _run(cell, seed, seconds, transform=None):
    result, _ = run.run_cell(cell, seed, seconds, False, _cuda(),
                             log=lambda *a: None,
                             t_start=time.perf_counter(),
                             transform=transform, measure=False)
    return result


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_survey_control_is_not_correct(seed):
    _cuda()
    cell = load_cell("survey.solve")
    cell.config.update(cams=2048, lines_per_cam=8)
    cell.traffic.update(maps=1, checked_maps=1)
    assert _run(cell, seed, 0.0)["correct"] is True
    control = _run(cell, seed, 0.0, transform=cell.driver().control)
    assert control["correct"] is False, control["checks"]
