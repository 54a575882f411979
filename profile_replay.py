"""Where the time of the port's replay goes, on one NVIDIA GPU.

    python3 profile_replay.py          # one card, no arguments, ~7 min

The replay is chip_smoke.py's phase 4: BatchSlam on CUDA in float32 with
bench.py's configuration, 400 house frames of render seed 4.  It runs

1. the plain replay twice, back to back: wall, process CPU time and kf/s
   of each, the spread of the per-frame wall (``FrameStep.step``, host
   clock) and the slowest frame, and whether the two runs agree bit for
   bit (LM iterations, trajectory).  The first run of a process holds the
   warm-up (lazy CUDA module loads, solver handles);
2. the replay once more with ``torch.cuda.synchronize()`` around each
   stage (triangulation, RANSAC, the pose-only LM polish, the whole VO,
   lines-GN, the window BA): seconds and calls per stage.  The syncs
   inflate the wall;
3. ``torch.profiler`` over the first 30 frames: the device busy time
   (union of the CUDA activity intervals), its share of the same frames'
   wall without the profiler (the profiler inflates the wall), device
   operations per frame and the ten device kernels that take most time.

Each part prints one JSON line.  Without a CUDA device it exits 1.

    python3 profile_replay.py --kernels ROOT

instead times the window-BA kernels of the checkout at ROOT (default:
this one): K2 ``fused_eval`` (the full evaluate, (C, L, O) = (20, 81,
1600)) and K1 ``segment_sum`` at (O, D, P) = (1600, 21, 81) and (1600, 1,
81) without a plan, in float32 (K2 gets its plan, built once outside the
timing, where the checkout has one), on the inputs of this checkout's
``kernel_checks``: eager CUDA events over 50 launches (``ms``, the host's
enqueue included) and the replay of a CUDA graph of 50 captured launches
(``device_ms``).  It calls only what every version of the port has, so two
commits compare in one call: unpack the other into a git-ignored
directory and run parent, change, change, parent.
"""

import argparse
import contextlib
import os
import sys
import time

import numpy as np

from chip_smoke import (bench_config, cuda_ms, graph_ms, house, log,
                        nvidia_smi, raw_ate)

PROFILED_FRAMES = 30


@contextlib.contextmanager
def patched(module, name, wrap):
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def frame_walls(eng, frames):
    """(result, per-frame wall seconds of FrameStep.step)."""
    from slslam_tpu_torch.engine import batch
    walls = []

    def wrap(step):
        def timed(*a, **k):
            t0 = time.perf_counter()
            out = step(*a, **k)
            walls.append(time.perf_counter() - t0)
            return out
        return timed

    with patched(batch.FrameStep, "step", wrap):
        res = eng.run(frames)
    return res, np.asarray(walls)


def stage_times(eng, frames, sync):
    """(result, {stage: {"s", "calls"}}) with ``sync()`` around each
    stage."""
    from slslam_tpu_torch.engine import batch
    from slslam_tpu_torch.ops import vo_pipeline
    stages = ((batch, "triangulate_lines", "triangulate"),
              (vo_pipeline, "ransac_stage", "vo.ransac"),
              (vo_pipeline, "local_ba", "vo.pose_only_lm"),
              (batch, "vo_body", "vo.total"),
              (batch, "lines_gn", "lines_gn"),
              (batch, "local_ba", "window_ba"))
    acc = {label: {"s": 0.0, "calls": 0} for _, _, label in stages}

    def timer(label):
        def wrap(fn):
            def timed(*a, **k):
                sync()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                sync()
                acc[label]["s"] += time.perf_counter() - t0
                acc[label]["calls"] += 1
                return out
            return timed
        return wrap

    with contextlib.ExitStack() as stack:
        for module, name, label in stages:
            stack.enter_context(patched(module, name, timer(label)))
        res = eng.run(frames)
    return res, acc


def busy_seconds(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def device_profile(eng, frames, sync):
    import torch
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    t0 = time.perf_counter()
    eng.run(frames)
    sync()
    plain_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        eng.run(frames)
        sync()
    wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_seconds([(e.time_range.start * 1e-6, e.time_range.end * 1e-6)
                         for e in dev])
    by_name = {}
    for e in dev:
        s, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (s + e.time_range.elapsed_us() * 1e-6, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"frames": len(frames), "wall_s": plain_wall,
            "profiled_wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / plain_wall,
            "device_ops_per_frame": len(dev) / len(frames),
            "top_device": [[name[:100], s, n] for name, (s, n) in top]}


def same_run(a, b):
    return {"ba_iters_equal": bool(np.array_equal(a.per_frame["ba_iters"],
                                                  b.per_frame["ba_iters"])),
            "max_traj_diff_m": max(float(np.linalg.norm(x.t - y.t))
                                   for x, y in zip(a.trajectory,
                                                   b.trajectory))}


def kernel_times(root):
    """Times of the window-BA kernels of the checkout at ``root``, on the
    inputs of this checkout's kernel_checks (the same inputs whichever
    checkout is timed)."""
    import torch
    from slslam_tpu_torch import kernel_checks as kc
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    args = kc.k2_case(torch.float32, dev)
    k1_args = {shape: kc.k1_case(*shape, torch.float32, dev)
               for shape in ((1600, 21, 81), (1600, 1, 81))}
    # now import the port of the checkout at root
    for name in [m for m in sys.modules
                 if m.split(".")[0] == "slslam_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, root)
    from slslam_tpu_torch.ops import kernels
    if not os.path.samefile(os.path.dirname(kernels.CSRC_DIR),
                            os.path.join(root, "slslam_tpu_torch")):
        raise RuntimeError(f"imported the port from {kernels.CSRC_DIR}, "
                           f"not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.load_library()
    out = {"root": root, "nvidia_smi": nvidia_smi()}
    kw = {}
    if hasattr(kernels, "ba_plan"):
        # the plan is built once per solve, as the main path does (PR 1's
        # port has no plans)
        kw["plan"] = kernels.ba_plan(args["obs_cam"], args["obs_line"],
                                     args["w_valid"], 20, 81, "full")
    out["fused_eval_full"] = {
        "plan_reused": bool(kw),
        "ms": cuda_ms(lambda: kernels.fused_eval(**args, **kw)),
        "device_ms": graph_ms(lambda: kernels.fused_eval(**args, **kw))}
    for (O, D, P), (vals, idx) in k1_args.items():
        out[f"segment_sum_{O}_{D}_{P}"] = {
            "ms": cuda_ms(lambda: kernels.segment_sum(vals, idx, P)),
            "device_ms": graph_ms(lambda: kernels.segment_sum(vals, idx, P))}
    log(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", metavar="ROOT", nargs="?", default=None,
                    const=os.path.dirname(os.path.abspath(__file__)),
                    help="time the kernels of the checkout at ROOT instead")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_replay: torch.cuda.is_available() is False",
              file=sys.stderr)
        sys.exit(1)
    if opts.kernels is not None:
        kernel_times(os.path.abspath(opts.kernels))
        return
    from slslam_tpu_torch.engine.batch import BatchSlam
    from slslam_tpu_torch.ops import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kernels.load_library()
    cfg = bench_config("float32")
    frames, poses = house(cfg, 400)
    eng = BatchSlam(cfg, device=dev)
    sync = torch.cuda.synchronize
    log({"part": 0, "nvidia_smi": nvidia_smi(), "torch": torch.__version__,
         "cpu_count": os.cpu_count(), "torch_threads": torch.get_num_threads(),
         "kernel_build_s": kernels.build_seconds})

    runs = []
    for rep in range(2):
        sync()
        t0, c0 = time.perf_counter(), time.process_time()
        res, walls = frame_walls(eng, frames)
        sync()
        wall = time.perf_counter() - t0
        cpu = time.process_time() - c0
        runs.append(res)
        q = np.quantile(walls, [0.1, 0.5, 0.9])
        log({"part": 1, "run": rep, "wall_s": wall, "cpu_s": cpu,
             "kf_per_s": res.kf_count / wall,
             "ate_raw_m": raw_ate(res.trajectory, poses),
             "window_lm_iterations": int(np.sum(res.per_frame["ba_iters"])),
             "frame_ms": {"first": walls[0] * 1e3, "p10": q[0] * 1e3,
                          "p50": q[1] * 1e3, "p90": q[2] * 1e3,
                          "max": walls.max() * 1e3,
                          "max_at": int(np.argmax(walls))}})
    log({"part": 1, "run0_vs_run1": same_run(runs[0], runs[1])})

    t0 = time.perf_counter()
    res, stages = stage_times(eng, frames, sync)
    wall = time.perf_counter() - t0
    log({"part": 2, "wall_synced_s": wall, "stages": stages,
         "run0_vs_synced": same_run(runs[0], res)})

    log({"part": 3, **device_profile(eng, frames[:PROFILED_FRAMES], sync)})


if __name__ == "__main__":
    main()
