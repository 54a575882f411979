"""The check that decides ``correct`` fails a broken timed path: the
survey cell's run is driven on the CPU at a small size with the program
broken underneath in each way the cell can break (the driver's
``plant``: a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced; one card, so no
exchange between cards to leave out), and ``correct`` comes out false;
unbroken, it comes out true."""

from __future__ import annotations

import pytest

from benchmark.tests.conftest import run_tiny, tiny_cell


@pytest.mark.parametrize("kind", [None, "unchanged", "half", "altered"])
def test_fault_makes_correct_false(kind, monkeypatch, cpu_only):
    cell = tiny_cell("survey.solve")
    if kind is not None:
        cell.driver().plant(kind, monkeypatch.setattr)
    result = run_tiny(cell)
    assert result["correct"] is (kind is None), result["checks"]
