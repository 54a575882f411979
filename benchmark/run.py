"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Reads ``BENCHMARK.json`` at the root of the checkout, finds the cell's
configuration, traffic mix, driver and metric readers by name
(``benchmark/harness/spec.py``), and then:

1. set-up (``setup_s``, from the start of this process): the driver makes
   the cell's inputs from ``--seed``, builds the system under test
   (``slslam_tpu_torch``) and warms up every shape the window uses;
2. the window: the driver runs whole units of work (for the survey
   solves, a round over the pool of maps) back to back and closes after
   the first unit that ends at or after ``--seconds``; where a metric reads
   the device, the profiler records the card's operations over it
   (``harness/trace.py``);
3. the peak device memory is read, the program's state is freed, and the
   driver compares what the window produced with the plain reference
   under ``benchmark/reference/`` (``correct``); each number compared is
   printed beside its limit, on standard error and under ``checks``;
4. the cell's end-to-end metrics (``--trace 0``) or per-layer metrics
   (``--trace 1``, with ``breakdown``) are read and printed as one JSON
   line, the last line of standard output.

It exits with 2 and prints no result without the cards the cell asks
for, and with 3 if ``jax``, ``jaxlib``, ``flax`` or the JAX package
``slslam_tpu`` was loaded (compared by whole top-level module name).
Build and kernel caches stay inside the checkout (``build/``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# import the benchmark as the package ``benchmark`` from the checkout's
# root, never its folders (drivers, metrics, ...) as top-level names
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "slslam_tpu")


def forbidden_modules():
    """The forbidden top-level names among the loaded modules."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs(root=ROOT):
    """Fixed cache directories inside the checkout for the program's
    builds (its own nvcc builds go to build/kernels, beside these)."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


@dataclass
class Ctx:
    """What a driver is given: the cell, the seed, the run's device."""

    cell: object
    seed: int
    device: object
    log: object

    @property
    def config(self):
        return self.cell.config

    @property
    def traffic(self):
        return self.cell.traffic


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return []


def judge(checks, limits):
    """(correct, {name: {value, limit}}): every number finite and at or
    under its limit; a number without a limit is an error."""
    out, ok = {}, True
    for name, value in checks:
        if name not in limits:
            raise KeyError(f"no limit for the compared number {name!r}")
        lim = limits[name]
        good = isinstance(value, (int, float)) and math.isfinite(value) \
            and value <= lim
        ok = ok and good
        out[name] = {"value": value, "limit": lim}
    return ok, out


def run_cell(cell, seed, seconds, trace, device, log=None, t_start=None,
             transform=None, measure=True):
    """One run of ``cell``: (result dict, stderr lines).  ``device`` is
    where the program runs; the chip check is the caller's.  ``t_start``:
    where set-up starts (the process's start by default); ``transform
    (outputs, ctx)``: replaces the program's outputs before the check
    (the calibration's control); without ``measure`` no metric is read
    and nothing traced (the calibration's readings of ``correct``)."""
    import torch
    from benchmark.harness.trace import DeviceTrace

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    tf32 = bool(cell.config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    cuda = device.type == "cuda"
    if cuda:
        for i in range(cell.chips):
            torch.zeros(1, device=torch.device("cuda", i))
            torch.cuda.reset_peak_memory_stats(i)
    driver = cell.driver()
    ctx = Ctx(cell, int(seed), device, log)

    state = driver.setup(ctx)
    _sync(device)
    setup_s = time.perf_counter() - (T_START if t_start is None
                                     else t_start)

    metrics = cell.metrics(trace) if measure else []
    wants_device = cuda and (trace or any(
        m["source"] == "device_trace" for m in metrics))
    with DeviceTrace(wants_device) as tr:
        t0 = time.perf_counter()
        win = driver.window(state, ctx, seconds)
        _sync(device)
        window_s = time.perf_counter() - t0
    peak = (max(torch.cuda.max_memory_allocated(i)
                for i in range(cell.chips)) if cuda else 0)
    dev = tr.summary(window_s)

    outputs = driver.release(state, ctx)
    del state
    if transform is not None:
        outputs = transform(outputs, ctx)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    correct, checks = judge(driver.check(outputs, ctx),
                            cell.workload["limits"])
    check_s = time.perf_counter() - t1

    data = {"setup_s": setup_s, "window_s": window_s, "window": win,
            "device": dev, "config": cell.config, "traffic": cell.traffic}
    values = {}
    for m in metrics:
        v = cell.reader(m["name"])(data)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": int(win["attempted"]),
        "failed": int(win["failed"]),
        "metrics": values,
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else device.type),
                   "count": cell.chips if cuda else 1,
                   "memory_peak_bytes": int(peak)},
    }
    if trace and dev is not None:
        result["device"]["busy_s"] = dev["busy_s"]
        result["device"]["window_s"] = dev["window_s"]
        result["breakdown"] = {"device_ops": dev["device_ops"],
                               "idle_gaps": dev["idle_gaps"]}
    result["checks"] = checks
    extra = {"workload": cell.name, "seed": seed, "setup_s": setup_s,
             "window_s": window_s, "check_s": check_s,
             "window": win,
             "device_ops": None if dev is None else dev["ops"],
             "trace_stop_s": tr.stop_s, "trace_read_s": tr.read_s,
             "busy_s": None if dev is None else dev["busy_s"],
             "card": _card() if cuda else []}
    lines = [json.dumps(extra, default=float)]
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}"
              for k, v in checks.items()]
    lines.append(f"correct: {result['correct']}")
    return result, lines


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    cache_dirs()
    from benchmark.harness.spec import load_cell
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has {n}", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, args.trace,
                             torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
