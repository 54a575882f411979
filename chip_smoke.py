"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # one card, no arguments

Phases, each printing one JSON line:

0. environment: ``nvidia-smi`` name and power limit, the device, the nvcc
   build of the kernel libraries from slslam_tpu_torch/csrc (sm_90a, one
   nvcc per source, in parallel) and each kernel's registers and spills
   from ``-Xptxas -v``;
1. K1: the segment plan against its twin (identical), and ``segment_sum``
   with and without a plan against its twin on CPU copies, float32 and
   float64;
2. K2 ``fused_eval``, every variant (full, cams, lines) at its main-path
   shape against its twin, float32 and float64, a repeat launch that must
   agree bit for bit;
   phases 1 and 2 also time each kernel at the main path's shape in float32:
   eager CUDA events over 50 launches (``ms``, the host's enqueue included),
   the replay of a CUDA graph of 50 captured launches (``device_ms``), the
   plain twin (``plain_ms``) and, for K1, one ``index_add_`` into a
   pre-zeroed (P + 1, D) buffer (``library_ms``; the port never calls it).
   The plan is timed at both of the window's shapes, the line plan and the
   (cam, line) pair plan (``pair_plan`` in its record);
3. slice parity in float64: 60 house frames on CUDA (kernels) and on the
   CPU (twins), fed the same Gumbel noise: identical keyframes and RANSAC
   scores, trajectories within 1e-6 m, every K2 variant launched;
4. the slice at full size: BatchSlam on CUDA in float32 with the bench's
   configuration, 400 frames of render seed 4, timed after a 20-frame
   warm-up: 400 keyframes, 74 landmarks, finite poses, raw ATE <= 0.55 m
   (the JAX reference: 0.484 m); K2 ``full`` launches == window-BA LM
   iterations, ``lines`` launches == lines_gn_iters x lines-GN calls, 0 <
   ``cams`` launches <= moba_max_iter x frames, K1 and the plan launched,
   and no call of the torch.func Jacobian helpers on CUDA tensors.

Then a line with the card's name and power limit, a line with the kernels'
record, and the last line ``{"ok": true, "device": {...}}``.  Any failed
check raises: the script exits non-zero and prints no result.  Without a
CUDA device it exits 1 at once.
"""

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time


WARMUP_FRAMES = 20
GRAPH_LAUNCHES = 50
K1_SOURCE = "slslam_tpu_torch/csrc/segment_sum.cu"
K2_SOURCE = "slslam_tpu_torch/csrc/fused_eval.cu"
JAC_HELPERS = ("lba_residual_jac_batch", "lba_residual_jac_cam_batch",
               "lba_residual_jac_line_batch")


def log(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=50, warmup=5):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events around
    back-to-back eager calls: the host's enqueue is part of it)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, launches=GRAPH_LAUNCHES, replays=5):
    """Mean device milliseconds per call of ``fn``: ``launches`` calls
    captured in one CUDA graph, the graph replayed and timed with events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def bench_config(dtype):
    """bench.py's batch configuration (bench.py:115-120)."""
    from slslam_tpu_torch.config import SlamConfig
    return dataclasses.replace(
        SlamConfig(), compute_dtype=dtype, kf_rot_thr=1e-9, kf_tr_thr=1e-9,
        obs_buckets=(80, 2048), line_buckets=(80, 2048),
        corr_buckets=(80, 256))


def house(cfg, n, seed=4):
    from slslam_tpu_torch.sim import (StereoLineRenderer, house_segments,
                                      wave_trajectory)
    poses = wave_trajectory(num_frames=400)[:n]
    ren = StereoLineRenderer(house_segments(), cfg.camera, noise_px=0.2,
                             seed=seed)
    return [ren.observe(T) for T in poses], poses


def raw_ate(traj, poses_gt):
    """Mean position error, both rooted at frame 0 (bench.py:66-75)."""
    import numpy as np
    T0 = poses_gt[0]
    return float(np.mean([np.linalg.norm(T.t - (G @ T0.inv()).inv().t)
                          for T, G in zip(traj, poses_gt)]))


def ptxas_summary(reports):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from nvcc's
    -Xptxas -v reports (mangled names shortened)."""
    out = {}
    dtypes = {"f": "f32", "d": "f64"}
    for text in reports.values():
        name = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                mangled = m.group(1)
                k2 = re.search(r"fused_eval_kernelI([fd])Li(\d)E", mangled)
                k1 = re.search(r"seg_sum_kernelI([fd])E", mangled)
                if k2:
                    name = (f"fused_eval/{('full', 'cams', 'lines')[int(k2[2])]}"
                            f"/{dtypes[k2[1]]}")
                elif k1:
                    name = f"segment_sum/{dtypes[k1[1]]}"
                elif "seg_plan_kernel" in mangled:
                    name = "segment_plan"
                else:
                    name = mangled
                out[name] = {}
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and name:
                out[name].update(spill_stores=int(m[1]),
                                 spill_loads=int(m[2]))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out[name]["registers"] = int(m[1])
    return out


def phase0(dev):
    from slslam_tpu_torch.ops import kernels
    import torch
    smi = nvidia_smi()
    kernels.load_library()
    log({"phase": 0, "nvidia_smi": smi,
         "device": torch.cuda.get_device_name(dev),
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "kernel_build_s": kernels.build_seconds,
         "ptxas": ptxas_summary(kernels.ptxas_log),
         "tf32_matmul": torch.backends.cuda.matmul.allow_tf32})
    return smi


def phase1(dev, rec):
    import torch
    from slslam_tpu_torch import kernel_checks as kc
    from slslam_tpu_torch.ops import kernels
    out = {"phase": 1,
           "plans": {str(s): d for s, d in kc.check_plans(dev)}}
    for dtype in (torch.float32, torch.float64):
        for shape, err, max_abs in kc.check_k1(dtype, dev):
            out[f"{str(dtype)[6:]}_{shape}"] = {"err": err,
                                                "max_abs_err": max_abs}

    # the plan at the main path's line plan and (cam, line) pair plan, K1
    # at lines-GN's trial cost
    for i, shape in enumerate(kc.PLAN_SHAPES[:2]):
        O, P = shape
        key = kc.plan_case(O, P, dev)
        times = dict(
            shape=[O, P], max_abs_err=float(out["plans"][str(shape)]),
            ms=cuda_ms(lambda: kernels.segment_plan(key, P)),
            device_ms=graph_ms(lambda: kernels.segment_plan(key, P)),
            plain_ms=cuda_ms(lambda: kernels.segment_plan_twin(key, P)),
            library_ms=None)
        times.update(zip(("bound_ms", "bound_by"),
                         kc.bound(*kc.plan_work(O, P))))
        if i == 0:
            rec["segment_plan"].update(times)
        else:
            rec["segment_plan"]["pair_plan"] = times

    O, D, P = kc.K1_SHAPES[0]
    vals, idx = kc.k1_case(O, D, P, torch.float32, dev)
    plan = kernels.segment_plan(idx, P)
    buf = torch.zeros((P + 1, D), dtype=vals.dtype, device=dev)
    rec["segment_sum"].update(
        shape=[O, D, P],
        max_abs_err=out[f"float32_{(O, D, P, True)}"]["max_abs_err"],
        ms=cuda_ms(lambda: kernels.segment_sum(vals, idx, P, plan=plan)),
        device_ms=graph_ms(lambda: kernels.segment_sum(vals, idx, P,
                                                       plan=plan)),
        plain_ms=cuda_ms(lambda: kernels.segment_sum_twin(vals, idx, P)),
        library_ms=cuda_ms(lambda: buf.index_add_(0, idx, vals)))
    rec["segment_sum"].update(zip(("bound_ms", "bound_by"),
                                  kc.bound(*kc.k1_work(vals, idx, P))))
    fields = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")
    out["times_float32"] = {
        "segment_plan": {f: rec["segment_plan"][f] for f in fields},
        "segment_plan_pair": {f: rec["segment_plan"]["pair_plan"][f]
                              for f in fields},
        "segment_sum": {f: rec["segment_sum"][f] for f in fields}}
    # without a plan the wrapper builds one first: two launches
    out["segment_sum_no_plan_ms"] = cuda_ms(
        lambda: kernels.segment_sum(vals, idx, P))
    log(out)


def phase2(dev, rec):
    import torch
    from slslam_tpu_torch import kernel_checks as kc
    from slslam_tpu_torch.ops import kernels
    out = {"phase": 2, "shapes": kc.K2_SHAPES}
    for variant in kernels.VARIANTS:
        name = f"fused_eval/{variant}"
        for dtype in (torch.float32, torch.float64):
            errs = kc.check_k2(dtype, dev, variant)
            out[f"{variant}_{str(dtype)[6:]}"] = {
                k: {"err": e, "max_abs_err": m} for k, (e, m) in errs.items()}
        args, plan = kc.k2_variant_case(variant, torch.float32, dev)

        def kernel():
            return kernels.fused_eval(**args, variant=variant, plan=plan)

        nbytes, ops = kc.k2_work(args, variant, plan)
        rec[name].update(
            shape=list(kc.K2_SHAPES[variant]),
            max_abs_err=max(v["max_abs_err"]
                            for v in out[f"{variant}_float32"].values()),
            ms=cuda_ms(kernel), device_ms=graph_ms(kernel),
            plain_ms=cuda_ms(lambda: kernels.fused_eval_twin(
                **args, variant=variant), reps=20),
            library_ms=None)
        rec[name].update(zip(("bound_ms", "bound_by"), kc.bound(nbytes, ops)))
        out[f"{variant}_times_float32"] = {f: rec[name][f] for f in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}
    log(out)


def variant_launches(launches):
    from slslam_tpu_torch.ops import kernels
    return {v: launches[f"fused_eval/{v}"] for v in kernels.VARIANTS}


def phase3(dev):
    import numpy as np
    import torch
    from slslam_tpu_torch.engine.batch import BatchSlam
    from slslam_tpu_torch.ops import kernels
    from slslam_tpu_torch.ops.ransac import gumbel_noise
    cfg = bench_config("float64")
    frames, _ = house(cfg, 60)
    H = cfg.ransac_num_hypotheses

    def hook(fidx, Lp=81):
        g = torch.Generator().manual_seed(1000 + fidx)
        return gumbel_noise(g, (H, Lp), torch.float64, "cpu")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    gpu = BatchSlam(cfg, device=dev, gumbel_hook=hook).run(frames)
    t_gpu = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    t0 = time.perf_counter()
    cpu = BatchSlam(cfg, device="cpu", gumbel_hook=hook).run(frames)
    t_cpu = time.perf_counter() - t0
    differ = np.flatnonzero(gpu.per_frame["ba_iters"]
                            != cpu.per_frame["ba_iters"]).tolist()
    dtraj = max(float(np.linalg.norm(a.t - b.t))
                for a, b in zip(gpu.trajectory, cpu.trajectory))
    log({"phase": 3, "frames": len(frames), "kf": gpu.kf_count,
         "max_traj_diff_m": dtraj, "ba_iters_differ_at": differ,
         "launches_cuda": launches, "wall_cuda_s": t_gpu,
         "wall_cpu_s": t_cpu})
    if not np.array_equal(gpu.is_kf, cpu.is_kf):
        raise AssertionError("phase 3: is_kf differs between CUDA and CPU")
    if not np.array_equal(gpu.per_frame["ransac_score"],
                          cpu.per_frame["ransac_score"]):
        raise AssertionError("phase 3: ransac_score differs")
    if len(gpu.trajectory) != len(cpu.trajectory) or not dtraj <= 1e-6:
        raise AssertionError(f"phase 3: trajectories differ by {dtraj} m")
    idle = [v for v, n in variant_launches(launches).items() if n == 0]
    if idle:
        raise AssertionError(f"phase 3: K2 variants never launched: {idle}")


@contextlib.contextmanager
def counting(modules, names, count, when=lambda *a, **k: True):
    """Wrap ``module.name`` for each module and name so that each call
    for which ``when(*args)`` holds adds one to ``count[name]``."""
    saved = []
    for module in modules:
        for name in names:
            orig = getattr(module, name)

            def wrapped(*a, _orig=orig, _name=name, **k):
                if when(*a, **k):
                    count[_name] += 1
                return _orig(*a, **k)

            saved.append((module, name, orig))
            setattr(module, name, wrapped)
    try:
        yield count
    finally:
        for module, name, orig in saved:
            setattr(module, name, orig)


def phase4(dev, rec):
    import numpy as np
    import torch
    from slslam_tpu_torch.engine import batch
    from slslam_tpu_torch.ops import kernels, residuals
    cfg = bench_config("float32")
    frames, poses = house(cfg, 400)
    eng = batch.BatchSlam(cfg, device=dev)
    # warm-up outside the timed window: the first float32 frames load their
    # CUDA modules and solver state
    eng.run(frames[:WARMUP_FRAMES])
    torch.cuda.synchronize()
    calls = dict.fromkeys(JAC_HELPERS + ("lines_gn", "local_ba"), 0)
    with contextlib.ExitStack() as stack:
        stack.enter_context(counting(
            (kernels, residuals), JAC_HELPERS, calls,
            when=lambda cw, *a, **k: cw.device.type == "cuda"))
        stack.enter_context(counting((batch,), ("lines_gn", "local_ba"),
                                     calls))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = eng.run(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
    ate = raw_ate(res.trajectory, poses)
    lm_iters = int(np.sum(res.per_frame["ba_iters"]))
    by_variant = variant_launches(launches)
    jac_cuda = sum(calls[k] for k in JAC_HELPERS)
    out = {"phase": 4, "frames": len(frames), "kf": res.kf_count,
           "landmarks": res.stats["num_landmarks"], "wall_s": wall,
           "kf_per_s": res.kf_count / wall, "ate_raw_m": ate,
           "avg_ba_iterations": res.stats["avg_num_iterations"],
           "window_lm_iterations": lm_iters, "lines_gn_calls":
           calls["lines_gn"], "window_ba_calls": calls["local_ba"],
           "jacobian_helper_calls_cuda": jac_cuda,
           "launches": launches}
    log(out)
    finite = all(np.all(np.isfinite(T.t)) and np.all(np.isfinite(T.R))
                 for T in res.trajectory)
    checks = {
        "400 keyframes": res.kf_count == 400,
        "74 landmarks": res.stats["num_landmarks"] == 74,
        "finite poses": finite,
        "raw ATE <= 0.55 m": ate <= 0.55,
        "full launches == LM iterations": by_variant["full"] == lm_iters,
        "lines launches == lines_gn_iters x calls":
            by_variant["lines"] == cfg.lines_gn_iters * calls["lines_gn"],
        "0 < cams launches <= moba_max_iter x frames":
            0 < by_variant["cams"] <= cfg.moba_max_iter * len(frames),
        "K1 launched": launches["segment_sum"] > 0,
        "plans built": launches["segment_plan"] > 0,
        "no torch.func Jacobians on CUDA": jac_cuda == 0,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 4 failed: {failed}")
    for name, n in launches.items():
        rec[name]["launches"] = n
    # each window-BA solve builds one pair plan
    rec["segment_plan"]["pair_plan"]["launches"] = calls["local_ba"]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        sys.exit(1)
    from slslam_tpu_torch.ops import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    k2_line = "slslam_tpu/ops/pallas_kernels.py:385"
    rec = {name: {"name": name, "route": "cuda", "source": source,
                  "replaces": replaces}
           for name, source, replaces in (
               ("segment_plan", K1_SOURCE,
                "slslam_tpu/ops/pallas_kernels.py:64"),
               ("segment_sum", K1_SOURCE,
                "slslam_tpu/ops/pallas_kernels.py:64"),
               *((f"fused_eval/{v}", K2_SOURCE, k2_line)
                 for v in kernels.VARIANTS))}
    smi = phase0(dev)
    phase1(dev, rec)
    phase2(dev, rec)
    phase3(dev)
    phase4(dev, rec)
    if "jax" in sys.modules or any(m == "slslam_tpu" or
                                   m.startswith("slslam_tpu.")
                                   for m in sys.modules):
        raise AssertionError("chip_smoke imported jax or slslam_tpu")
    print(smi)
    log({"kernels": list(rec.values())})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
