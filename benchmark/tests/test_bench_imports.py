"""Nothing the benchmark runs imports JAX or the JAX package: a fresh
interpreter loads every module of the benchmark and runs a cell on the
CPU, and the loaded modules' top-level names (compared whole) hold none
of jax, jaxlib, flax or slslam_tpu."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from benchmark.run import FORBIDDEN

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PROBE = r"""
import glob, json, os, sys, time
sys.path.insert(0, {root!r})
import torch
from benchmark import run, calibrate
from benchmark.harness.spec import load_cell, load_json, load_module
from benchmark.tests.conftest import tiny_cell, run_tiny
bench = load_json(os.path.join({root!r}, "BENCHMARK.json"))
for path in sorted(glob.glob(os.path.join({root!r}, "benchmark", "**",
                                          "*.py"), recursive=True)):
    if "/tests/" not in path:
        load_module(path, "probe_" + os.path.basename(path)[:-3].replace(
            ".", "_"))
for w in bench["workloads"]:
    cell = load_cell(w["name"])
    cell.driver()
    for m in cell.end_to_end + cell.per_layer:
        cell.reader(m["name"])
import slslam_tpu_torch.ops.schur_cg
result = run_tiny(tiny_cell("survey.solve"))
print(json.dumps({{"loaded": sorted({{m.split(".")[0]
                                     for m in sys.modules}}),
                  "correct": result["correct"]}}))
"""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import types

    from benchmark import run
    assert FORBIDDEN == ("jax", "jaxlib", "flax", "slslam_tpu")
    monkeypatch.setitem(sys.modules, "slslam_tpu_torch_probe.sub",
                        types.ModuleType("slslam_tpu_torch_probe.sub"))
    assert "slslam_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "slslam_tpu.probe",
                        types.ModuleType("slslam_tpu.probe"))
    assert "slslam_tpu" in run.forbidden_modules()


def test_benchmark_loads_no_jax():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert "slslam_tpu_torch" in rec["loaded"]
    assert not set(rec["loaded"]) & set(FORBIDDEN), rec["loaded"]
    assert rec["correct"] is True
