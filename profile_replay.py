"""Where the time of the port's replay and refine goes, on one NVIDIA GPU.

    python3 profile_replay.py          # one card, no arguments, ~8 min

The replay is chip_smoke.py's phase 4: BatchSlam on CUDA in float32 with
bench.py's configuration, 400 house frames of render seed 4; the refine is
its phase 5, ``global_refine`` of that replay with 3 rounds (the bench's).
It runs

1. the plain replay twice, back to back, each followed by the plain
   refine: wall, process CPU time and kf/s of each replay, the spread of
   the per-frame wall (``FrameStep.step``, host clock) and the slowest
   frame, the refine's wall and refined ATE, and whether the two runs
   agree bit for bit (LM iterations, trajectory).  The first run of a
   process holds the warm-up (lazy CUDA module loads, solver handles);
2. the replay once more with ``torch.cuda.synchronize()`` around each
   stage (triangulation, RANSAC, the pose-only LM polish, the whole VO,
   lines-GN, the window BA), then the refine with synced stages of its
   own (the line init, K2 ``lm``'s evaluate, the PCG step, the trial
   cost, each CG solve, the whole refine): seconds and calls per stage.
   The syncs inflate the wall;
3. ``torch.profiler`` over the first 30 frames: the device busy time
   (union of the CUDA activity intervals), its share of the same frames'
   wall without the profiler (the profiler inflates the wall), device
   operations per frame and the ten device kernels that take most time;
4. the same over one whole refine.

Each part prints one JSON line.  Without a CUDA device it exits 1.

    python3 profile_replay.py --kernels ROOT

instead times the kernels of the checkout at ROOT (default: this one) in
float32, on the inputs of this checkout's ``kernel_checks``: K2
``fused_eval`` at each variant's main-path shape (``full``, ``cams`` and
``lines`` at the window's, ``lm`` at the refine's) and ``lm`` at the large
map's (8192, 109,147, 3,492,704) with its ~73 % padding, each with its
plan built once outside the timing where the checkout has plans; K1
``segment_sum`` at (O, D, P) = (1600, 21, 81) and (1600, 1, 81) without a
plan; and the segment plan at every shape of ``PLAN_SHAPES`` and
``PLAN_LARGE_SHAPES`` (the window's, the refine's, the large map's, the
scaling tool's, the interactive window's and the PGO's).  Each gets eager
CUDA events over 50 launches (``ms``, the host's enqueue included) and the
replay of a CUDA graph of 50 captured launches (``device_ms``), fewer
where one launch is long (chip_smoke._reps).  It calls only what every
version of the port has, so two commits compare in one call: unpack the
other into a git-ignored directory and run parent, change, change,
parent.  Where the checkout's plan has several paths, the plan is also
timed on each path that can take the shape.

    python3 profile_replay.py --refine ROOT [--seed N]

runs part 1's replay once with the port of the checkout at ROOT (render
seed 4, or ``--seed``), then its refine three times back to back, and prints each refine's wall and its LM
and PCG iterations by solve; run it in its own process for each checkout.
"""

import argparse
import contextlib
import os
import sys
import time

import numpy as np

from chip_smoke import cuda_ms, graph_ms, log, nvidia_smi

PROFILED_FRAMES = 30
REFINE_ROUNDS = 3


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

    with contextlib.ExitStack() as stack:
        for module, name, label in stages:
            stack.enter_context(patched(module, name,
                                        synced_timer(acc[label], sync)))
        res = eng.run(frames)
    return res, acc


def refine_stage_times(frames, res, cfg, dev, sync):
    """(RefineResult, {stage: {"s", "calls"}}) of the refine with
    ``sync()`` around each of its stages."""
    from slslam_tpu_torch.engine import refine
    from slslam_tpu_torch.ops import schur_cg
    stages = ((refine, "init_problem_values", "refine.line_init"),
              (schur_cg, "_eval_system_lm", "refine.lm_evaluate"),
              (schur_cg, "_solve_step_cg", "refine.pcg_step"),
              (schur_cg, "_cost_lm", "refine.trial_cost"),
              (refine, "global_ba_cg", "refine.cg_solve"),
              (refine, "global_refine", "refine.total"))
    acc = {label: {"s": 0.0, "calls": 0} for _, _, label in stages}
    with contextlib.ExitStack() as stack:
        for module, name, label in stages:
            stack.enter_context(patched(module, name,
                                        synced_timer(acc[label], sync)))
        ref = refine.global_refine(frames, res.is_kf, res.trajectory,
                                   config=cfg, rounds=REFINE_ROUNDS,
                                   device=dev)
    return ref, acc


def synced_timer(slot, sync):
    """A wrapper that adds a call's synced seconds to ``slot``."""
    def wrap(fn):
        def timed(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            slot["s"] += time.perf_counter() - t0
            slot["calls"] += 1
            return out
        return timed
    return wrap


def busy_seconds(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def device_profile(run, sync):
    """Device activity of ``run()``: its plain wall, then the union of the
    CUDA activity intervals of a profiled run and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    t0 = time.perf_counter()
    run()
    sync()
    plain_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        run()
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
    return {"wall_s": plain_wall, "profiled_wall_s": wall,
            "device_busy_s": busy, "device_busy_share": busy / plain_wall,
            "device_ops": len(dev),
            "top_device": [[name[:100], s, n] for name, (s, n) in top]}


def same_run(a, b):
    return {"ba_iters_equal": bool(np.array_equal(a.per_frame["ba_iters"],
                                                  b.per_frame["ba_iters"])),
            "max_traj_diff_m": max(float(np.linalg.norm(x.t - y.t))
                                   for x, y in zip(a.trajectory,
                                                   b.trajectory))}


def kernel_times(root):
    """Times of the kernels of the checkout at ``root``, on the inputs of
    this checkout's kernel_checks (the same inputs whichever checkout is
    timed)."""
    import torch
    from slslam_tpu_torch import kernel_checks as kc
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    args = kc.k2_case(torch.float32, dev)
    k1_args = {shape: kc.k1_case(*shape, torch.float32, dev)
               for shape in ((1600, 21, 81), (1600, 1, 81))}
    k2_args = {(v, shape): kc.k2_lm_case(
        torch.float32, dev, C=shape[0], L=shape[1], kL=shape[2] // shape[1],
        pad_frac=pad) if v == "lm" else kc.k2_case(
        torch.float32, dev, *shape)
        for v, shape, pad in (
            ("cams", kc.K2_SHAPES["cams"], None),
            ("lines", kc.K2_SHAPES["lines"], None),
            ("lm", kc.K2_SHAPES["lm"], 0.008),
            ("lm", (kc.MAP_C, kc.MAP_L, kc.MAP_O), kc.MAP_PAD))}
    plan_keys = {(O, P): kc.plan_case(O, P, dev)
                 for O, P in kc.PLAN_SHAPES + kc.PLAN_LARGE_SHAPES}
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
    for (variant, shape), a in k2_args.items():
        plan = kernels.ba_plan(a["obs_cam"], a["obs_line"], a["w_valid"],
                               shape[0], shape[1], variant)

        def k2():
            return kernels.fused_eval(**a, variant=variant, plan=plan)

        out[f"fused_eval_{variant}_{'_'.join(map(str, shape))}"] = {
            "ms": cuda_ms(k2), "device_ms": graph_ms(k2)}
        del plan
    for (O, P), key in plan_keys.items():
        out[f"segment_plan_{O}_{P}"] = {
            "ms": cuda_ms(lambda: kernels.segment_plan(key, P)),
            "device_ms": graph_ms(lambda: kernels.segment_plan(key, P))}
        # each forced path that can take (O, P), where the checkout has
        # several (PR 9 on)
        paths = kernels.plan_paths(O, P)[1:] if hasattr(
            kernels, "plan_paths") else []
        for path in paths:
            def plan(path=path):
                return kernels.segment_plan(key, P, path=path)
            out[f"segment_plan_{O}_{P}"][path] = {
                "ms": cuda_ms(plan), "device_ms": graph_ms(plan)}
    log(out)


def refine_times(root, seed=4, reps=3):
    """The replay of part 1 once (render seed ``seed``), then ``reps``
    refines of it back to back,
    all with the port of the checkout at ``root`` (imported from there
    before anything else of the port): each refine's wall and its LM and
    PCG iterations by solve.  The first refine of the process holds the
    warm-up."""
    import torch
    sys.path.insert(0, root)
    from slslam_tpu_torch.bench import ate, bench_config, workload
    from slslam_tpu_torch.engine import refine
    from slslam_tpu_torch.engine.batch import BatchSlam
    from slslam_tpu_torch.ops import kernels
    if not os.path.samefile(os.path.dirname(kernels.CSRC_DIR),
                            os.path.join(root, "slslam_tpu_torch")):
        raise RuntimeError(f"imported the port from {kernels.CSRC_DIR}, "
                           f"not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kernels.load_library()
    cfg = bench_config("float32")
    frames, poses = workload(cfg, 400, seed)
    t0 = time.perf_counter()
    res = BatchSlam(cfg, device=dev).run(frames)
    torch.cuda.synchronize()
    out = {"root": root, "seed": seed, "nvidia_smi": nvidia_smi(),
           "replay_s": time.perf_counter() - t0,
           "ate_raw_m": ate(res.trajectory, poses), "refines": []}
    solves = []
    saved = refine.global_ba_cg

    def recorded(*a, **k):
        r = saved(*a, **k)
        solves.append((int(r[2].iterations), int(r[2].cg_iterations)))
        return r

    refine.global_ba_cg = recorded
    try:
        for _ in range(reps):
            solves.clear()
            t0 = time.perf_counter()
            ref = refine.global_refine(frames, res.is_kf, res.trajectory,
                                       config=cfg, rounds=REFINE_ROUNDS,
                                       device=dev)
            torch.cuda.synchronize()
            out["refines"].append({
                "wall_s": time.perf_counter() - t0,
                "lm_iterations": [i for i, _ in solves],
                "pcg_iterations": [c for _, c in solves],
                "ate_refined_m": ate(ref.trajectory, poses)})
    finally:
        refine.global_ba_cg = saved
    log(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", metavar="ROOT", nargs="?", default=None,
                    const=os.path.dirname(os.path.abspath(__file__)),
                    help="time the kernels of the checkout at ROOT instead")
    ap.add_argument("--refine", metavar="ROOT", default=None,
                    help="time the refine of the checkout at ROOT instead")
    ap.add_argument("--seed", type=int, default=4,
                    help="the render seed of --refine's replay")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_replay: torch.cuda.is_available() is False",
              file=sys.stderr)
        sys.exit(1)
    if opts.kernels is not None:
        kernel_times(os.path.abspath(opts.kernels))
        return
    if opts.refine is not None:
        refine_times(os.path.abspath(opts.refine), opts.seed)
        return
    from slslam_tpu_torch.bench import ate, bench_config, workload
    from slslam_tpu_torch.engine.batch import BatchSlam
    from slslam_tpu_torch.engine.refine import global_refine
    from slslam_tpu_torch.ops import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kernels.load_library()
    cfg = bench_config("float32")
    frames, poses = workload(cfg, 400, 4)
    eng = BatchSlam(cfg, device=dev)
    sync = torch.cuda.synchronize
    log({"part": 0, "nvidia_smi": nvidia_smi(), "torch": torch.__version__,
         "cpu_count": os.cpu_count(), "torch_threads": torch.get_num_threads(),
         "kernel_build_s": kernels.build_seconds})

    def refine(res):
        return global_refine(frames, res.is_kf, res.trajectory, config=cfg,
                             rounds=REFINE_ROUNDS, device=dev)

    runs = []
    for rep in range(2):
        sync()
        t0, c0 = time.perf_counter(), time.process_time()
        res, walls = frame_walls(eng, frames)
        sync()
        wall = time.perf_counter() - t0
        cpu = time.process_time() - c0
        t0, c0 = time.perf_counter(), time.process_time()
        ref = refine(res)
        sync()
        refine_wall = time.perf_counter() - t0
        refine_cpu = time.process_time() - c0
        runs.append(res)
        q = np.quantile(walls, [0.1, 0.5, 0.9])
        log({"part": 1, "run": rep, "wall_s": wall, "cpu_s": cpu,
             "kf_per_s": res.kf_count / wall,
             "ate_raw_m": ate(res.trajectory, poses),
             "window_lm_iterations": int(np.sum(res.per_frame["ba_iters"])),
             "frame_ms": {"first": walls[0] * 1e3, "p10": q[0] * 1e3,
                          "p50": q[1] * 1e3, "p90": q[2] * 1e3,
                          "max": walls.max() * 1e3,
                          "max_at": int(np.argmax(walls))},
             "refine_wall_s": refine_wall, "refine_cpu_s": refine_cpu,
             "refine_iterations": ref.iterations,
             "ate_refined_m": ate(ref.trajectory, poses),
             "replay_refine_kf_per_s": res.kf_count / (wall + refine_wall)})
    log({"part": 1, "run0_vs_run1": same_run(runs[0], runs[1])})

    t0 = time.perf_counter()
    res, stages = stage_times(eng, frames, sync)
    wall = time.perf_counter() - t0
    ref, refine_stages = refine_stage_times(frames, res, cfg, dev, sync)
    log({"part": 2, "wall_synced_s": wall, "stages": stages,
         "refine_stages": refine_stages,
         "refine_iterations": ref.iterations,
         "run0_vs_synced": same_run(runs[0], res)})

    head = frames[:PROFILED_FRAMES]
    prof = device_profile(lambda: eng.run(head), sync)
    prof["device_ops_per_frame"] = prof["device_ops"] / len(head)
    log({"part": 3, "frames": len(head), **prof})
    log({"part": 4, "refine_rounds": REFINE_ROUNDS,
         **device_profile(lambda: refine(res), sync)})


if __name__ == "__main__":
    main()
