"""The benchmark's registry: cells, configurations, traffic mixes, drivers
and metric readers, all found by name.

``BENCHMARK.json`` at the root of the checkout names the cells
(``workloads``), each with its configuration (``configs[].file``), its
traffic mix and its chips, and the metrics, each reported where its
``workloads`` key (or, without one, every cell) says.  Everything else
belongs to a file of its own:

* ``benchmark/workloads/<cell>.json``: the cell's limits on the numbers
  that decide ``correct`` (``limits``), and how many of its answers the
  check compares;
* ``benchmark/traffic/<traffic>.json``: the mix's parameters and the
  ``driver`` that runs it;
* ``benchmark/drivers/<driver>.py``: the general generator and driver of
  one kind of traffic (``setup``, ``window``, ``release``, ``check``);
* ``benchmark/metrics/<metric>.py``: ``read(data)``, the reader of one
  metric, which returns None where it finds nothing to read.  ``data``
  holds the run's ``setup_s`` and ``window_s``, the driver's ``window``
  record (``attempted``, ``failed`` and its own counts), ``device``
  (``harness/trace.py``'s summary, None where nothing was traced),
  ``config`` and ``traffic``.

A later cell, mix or metric is new files and new entries; no file here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """Import the Python file ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.isfile(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One cell as the harness runs it."""

    name: str
    root: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    workload: Dict[str, Any]
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)

    def driver(self):
        name = self.traffic["driver"]
        return load_module(os.path.join(self.root, "benchmark", "drivers",
                                        f"{name}.py"),
                           f"benchmark_driver_{name}")

    def reader(self, metric_name):
        """The ``read(data)`` of ``benchmark/metrics/<metric_name>.py``."""
        path = os.path.join(self.root, "benchmark", "metrics",
                            f"{metric_name}.py")
        return load_module(path, "benchmark_metric_" + metric_name.replace(
            ".", "_").replace("-", "_")).read

    def metrics(self, trace: bool):
        return self.per_layer if trace else self.end_to_end


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name, bench=None, root=ROOT):
    """The cell ``name`` of ``root``'s BENCHMARK.json (or of ``bench``)."""
    bench = bench if bench is not None else load_json(
        os.path.join(root, "BENCHMARK.json"))
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bench_dir = os.path.join(root, "benchmark")
    workload = load_json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    for key in ("config", "traffic", "chips"):
        if workload.get(key, w[key]) != w[key]:
            raise ValueError(f"workloads/{name}.json says {key} "
                             f"{workload[key]!r}, BENCHMARK.json {w[key]!r}")
    return Cell(
        name=name, root=root, chips=int(w["chips"]), config_name=w["config"],
        config=load_json(os.path.join(root, cfg["file"])),
        traffic_name=w["traffic"],
        traffic=load_json(os.path.join(bench_dir, "traffic",
                                       f"{w['traffic']}.json")),
        workload=workload,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])
