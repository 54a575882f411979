"""Readings for the limits of ``correct``: the program over many seeds and
the control over a few, at the cell's own size, in one process.

    python3 benchmark/calibrate.py --workload survey.solve \\
        --seeds 11 12 13 --control-seeds 21 22 23 [--witness-seeds 31] \\
        [--fault altered] [--seconds 0]

Each seed is one run of the cell (``run.run_cell``) with a window of
``--seconds`` (0: one unit of work); each prints one JSON line with the
numbers compared and the run's timings.  The control is the driver's
``control`` (the reference in a lower precision put in the program's
place), the witness its ``witness``; ``--fault KIND`` runs the program
seeds with the driver's ``plant(KIND)`` fault.  ``--set key=value``
overrides a number of the configuration (a rehearsal at a small size),
``--traffic key=value`` one of the traffic mix; ``--device cpu`` runs
the program's CPU path.  Nothing is traced or measured but the numbers
compared.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path[:] = [p for p in sys.path
               if os.path.abspath(p or ".") != os.path.dirname(
                   os.path.abspath(__file__))]
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--traffic", action="append", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run.cache_dirs()
    import torch
    from benchmark.harness.spec import load_cell
    cell = load_cell(args.workload)
    for kv in args.set:
        k, v = kv.split("=", 1)
        cell.config[k] = json.loads(v)
    for kv in args.traffic:
        k, v = kv.split("=", 1)
        cell.traffic[k] = json.loads(v)
    dev = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device(args.device)
    driver = cell.driver()
    if args.fault:
        driver.plant(args.fault, setattr)
    for kind, seeds in (("program", args.seeds),
                        ("control", args.control_seeds),
                        ("witness", args.witness_seeds)):
        for seed in seeds:
            transform = None if kind == "program" else getattr(driver, kind)
            t0 = time.perf_counter()
            result, lines = run.run_cell(cell, seed, args.seconds, False,
                                         dev, t_start=t0,
                                         transform=transform, measure=False)
            extra = json.loads(lines[0])
            label = f"fault:{args.fault}" if kind == "program" and \
                args.fault else kind
            print(json.dumps({
                "kind": label, "seed": seed, "correct": result["correct"],
                "checks": {k: v["value"]
                           for k, v in result["checks"].items()},
                "metrics": result["metrics"],
                "setup_s": extra["setup_s"], "window_s": extra["window_s"],
                "check_s": extra["check_s"],
                "window": extra["window"],
                "busy_s": extra["busy_s"],
                "peak": result["device"]["memory_peak_bytes"],
                "total_s": time.perf_counter() - t0}, default=float),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
