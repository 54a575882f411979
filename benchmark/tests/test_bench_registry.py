"""A later PR adds a cell, a traffic mix, a configuration and a per-layer
metric by adding files and BENCHMARK.json entries alone: a throwaway cell
registered that way in a copy of the benchmark runs on the CPU, reports
its new metric, and no file that was there changes."""

from __future__ import annotations

import filecmp
import json
import os
import shutil
import time

import torch

from benchmark import run
from benchmark.harness.spec import load_cell
from benchmark.tests.conftest import ROOT, TINY


def _write(path, obj):
    with open(path, "w") as f:
        if isinstance(obj, str):
            f.write(obj)
        else:
            json.dump(obj, f, indent=1)


def test_a_cell_from_files_alone(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = os.path.join(root, "benchmark")
    with open(os.path.join(ROOT, "benchmark", "configs", "survey.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY["survey.solve"], name="survey_small")
    _write(os.path.join(b, "configs", "survey_small.json"), cfg)
    _write(os.path.join(b, "traffic", "pool2.json"),
           {"driver": "survey_solve", "why": "two maps in turn",
            "maps": 2, "checked_maps": 1, "early_iters": 1})
    with open(os.path.join(b, "workloads", "survey.solve.json")) as f:
        limits = json.load(f)["limits"]
    _write(os.path.join(b, "workloads", "survey_small.pool2.json"),
           {"config": "survey_small", "traffic": "pool2", "chips": 1,
            "limits": limits})
    _write(os.path.join(b, "metrics", "solves.pool2.py"),
           '"""solves.pool2: solves the window completed."""\n\n\n'
           'def read(data):\n    return data["window"].get("solves")\n')
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "survey_small", "source": "test",
                             "file": "benchmark/configs/survey_small.json",
                             "reduced": ["cams"], "why": "test"})
    bench["workloads"].append({"name": "survey_small.pool2",
                               "config": "survey_small", "traffic": "pool2",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("survey_small.pool2")
    bench["per_layer"].append({
        "name": "solves.pool2", "unit": "solves", "better": "higher",
        "source": "program_counter", "layer": "global BA solver",
        "moves": "solve_s", "workloads": ["survey_small.pool2"]})
    _write(bench_path, bench)

    cell = load_cell("survey_small.pool2", root=root)
    assert cell.traffic["maps"] == 2 and cell.config["cams"] == 96
    for trace in (0, 1):
        result, _ = run.run_cell(cell, 5, 0.0, trace, torch.device("cpu"),
                                 log=lambda *a: None,
                                 t_start=time.perf_counter())
        assert result["correct"] is True, result["checks"]
        names = set(result["metrics"])
        if trace:
            assert names == {"solves.pool2"}
            assert result["metrics"]["solves.pool2"]["value"] == 2
        else:
            assert names == {"solve_s", "setup_s"}
    # every file that was there is unchanged
    for dirpath, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        if "__pycache__" in dirpath:
            continue
        rel = os.path.relpath(dirpath, ROOT)
        for name in files:
            assert filecmp.cmp(os.path.join(dirpath, name),
                               os.path.join(root, rel, name), shallow=False)
