"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # one card, no arguments

Phases, each printing one JSON line:

0. environment: ``nvidia-smi`` name and power limit, the device, and the
   nvcc build of both kernels from slslam_tpu_torch/csrc (sm_90a);
1. K1 ``segment_sum`` against its twin on CPU copies, at the main path's
   shapes, float32 and float64, plus kernel and twin times on the card;
2. K2 ``fused_eval`` against its twin at C=20, L=81, O=1600, float32 and
   float64, a repeat launch that must agree bit for bit, plus kernel and
   twin times (CUDA events, both on the card);
3. slice parity in float64: 60 house frames on CUDA (kernels) and on the
   CPU (twins), fed the same Gumbel noise: identical keyframes and RANSAC
   scores, trajectories within 1e-6 m;
4. the slice at full size: BatchSlam on CUDA in float32 with the bench's
   configuration, 400 frames of render seed 4, timed after a 20-frame
   warm-up: 400 keyframes, 74
   landmarks, finite poses, raw ATE <= 0.55 m (the JAX reference: 0.484 m),
   K2 launches == window-BA LM iterations, K1 launches > 0.

Then a line with the card's name and power limit, a line with the kernels'
record, and the last line ``{"ok": true, "device": {...}}``.  Any failed
check raises: the script exits non-zero and prints no result.  Without a
CUDA device it exits 1 at once.
"""

import dataclasses
import json
import subprocess
import sys
import time


WARMUP_FRAMES = 20


def log(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=50, warmup=5):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
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


def bench_config(dtype):
    """bench.py's batch configuration (bench.py:115-120)."""
    from slslam_tpu.config import SlamConfig
    return dataclasses.replace(
        SlamConfig(), compute_dtype=dtype, kf_rot_thr=1e-9, kf_tr_thr=1e-9,
        obs_buckets=(80, 2048), line_buckets=(80, 2048),
        corr_buckets=(80, 256))


def house(cfg, n, seed=4):
    from slslam_tpu.sim import (StereoLineRenderer, house_segments,
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


def phase0(dev):
    from slslam_tpu_torch.ops import kernels
    import torch
    smi = nvidia_smi()
    kernels.load_library()
    log({"phase": 0, "nvidia_smi": smi,
         "device": torch.cuda.get_device_name(dev),
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "kernel_build_s": kernels.build_seconds,
         "tf32_matmul": torch.backends.cuda.matmul.allow_tf32})
    return smi


def phase1(dev, rec):
    import torch
    from slslam_tpu_torch import kernel_checks as kc
    from slslam_tpu_torch.ops import kernels
    out = {"phase": 1}
    for dtype in (torch.float32, torch.float64):
        for shape, err, max_abs in kc.check_k1(dtype, dev):
            out[f"{str(dtype)[6:]}_{shape}"] = {"err": err,
                                                "max_abs_err": max_abs}
    times = {}
    for (O, D, P) in kc.K1_SHAPES:
        vals, idx = kc.k1_case(O, D, P, torch.float32, dev)
        times[str((O, D, P))] = {
            "ms": cuda_ms(lambda: kernels.segment_sum(vals, idx, P)),
            "plain_ms": cuda_ms(
                lambda: kernels.segment_sum_twin(vals, idx, P))}
    out["float32_times"] = times
    log(out)
    main = str(kc.K1_SHAPES[0])
    rec["segment_sum"].update(
        max_abs_err=out[f"float32_{kc.K1_SHAPES[0]}"]["max_abs_err"],
        ms=times[main]["ms"], plain_ms=times[main]["plain_ms"])


def phase2(dev, rec):
    import torch
    from slslam_tpu_torch import kernel_checks as kc
    from slslam_tpu_torch.ops import kernels
    out = {"phase": 2, "shape": kc.K2_SHAPE}
    for dtype in (torch.float32, torch.float64):
        errs = kc.check_k2(dtype, dev)
        out[str(dtype)[6:]] = {k: {"err": e, "max_abs_err": m}
                               for k, (e, m) in errs.items()}
        args = kc.k2_case(dtype, dev)
        out[str(dtype)[6:] + "_times"] = {
            "ms": cuda_ms(lambda: kernels.fused_eval(**args)),
            "plain_ms": cuda_ms(lambda: kernels.fused_eval_twin(**args),
                                reps=20)}
    log(out)
    rec["fused_eval"].update(
        max_abs_err=max(v["max_abs_err"] for v in out["float32"].values()),
        ms=out["float32_times"]["ms"], plain_ms=out["float32_times"]["plain_ms"])


def phase3(dev):
    import numpy as np
    import torch
    from slslam_tpu_torch.engine.batch import BatchSlam
    from slslam_tpu_torch.ops.ransac import gumbel_noise
    cfg = bench_config("float64")
    frames, _ = house(cfg, 60)
    H = cfg.ransac_num_hypotheses

    def hook(fidx, Lp=81):
        g = torch.Generator().manual_seed(1000 + fidx)
        return gumbel_noise(g, (H, Lp), torch.float64, "cpu")

    t0 = time.perf_counter()
    gpu = BatchSlam(cfg, device=dev, gumbel_hook=hook).run(frames)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = BatchSlam(cfg, device="cpu", gumbel_hook=hook).run(frames)
    t_cpu = time.perf_counter() - t0
    differ = np.flatnonzero(gpu.per_frame["ba_iters"]
                            != cpu.per_frame["ba_iters"]).tolist()
    dtraj = max(float(np.linalg.norm(a.t - b.t))
                for a, b in zip(gpu.trajectory, cpu.trajectory))
    log({"phase": 3, "frames": len(frames), "kf": gpu.kf_count,
         "max_traj_diff_m": dtraj, "ba_iters_differ_at": differ,
         "wall_cuda_s": t_gpu, "wall_cpu_s": t_cpu})
    if not np.array_equal(gpu.is_kf, cpu.is_kf):
        raise AssertionError("phase 3: is_kf differs between CUDA and CPU")
    if not np.array_equal(gpu.per_frame["ransac_score"],
                          cpu.per_frame["ransac_score"]):
        raise AssertionError("phase 3: ransac_score differs")
    if len(gpu.trajectory) != len(cpu.trajectory) or not dtraj <= 1e-6:
        raise AssertionError(f"phase 3: trajectories differ by {dtraj} m")


def phase4(dev, rec):
    import numpy as np
    import torch
    from slslam_tpu_torch.engine.batch import BatchSlam
    from slslam_tpu_torch.ops import kernels
    cfg = bench_config("float32")
    frames, poses = house(cfg, 400)
    eng = BatchSlam(cfg, device=dev)
    # warm-up outside the timed window: the first float32 frames load their
    # CUDA modules and solver state
    eng.run(frames[:WARMUP_FRAMES])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.run(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    ate = raw_ate(res.trajectory, poses)
    lm_iters = int(np.sum(res.per_frame["ba_iters"]))
    out = {"phase": 4, "frames": len(frames), "kf": res.kf_count,
           "landmarks": res.stats["num_landmarks"], "wall_s": wall,
           "kf_per_s": res.kf_count / wall, "ate_raw_m": ate,
           "avg_ba_iterations": res.stats["avg_num_iterations"],
           "window_lm_iterations": lm_iters, "launches": launches}
    log(out)
    finite = all(np.all(np.isfinite(T.t)) and np.all(np.isfinite(T.R))
                 for T in res.trajectory)
    checks = {
        "400 keyframes": res.kf_count == 400,
        "74 landmarks": res.stats["num_landmarks"] == 74,
        "finite poses": finite,
        "raw ATE <= 0.55 m": ate <= 0.55,
        "K2 launches == LM iterations": launches["fused_eval"] == lm_iters,
        "K1 launched": launches["segment_sum"] > 0,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 4 failed: {failed}")
    for name, n in launches.items():
        rec[name]["launches"] = n


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    rec = {
        "segment_sum": {"name": "segment_sum", "route": "cuda",
                        "source": "slslam_tpu_torch/csrc/segment_sum.cu",
                        "replaces": "slslam_tpu/ops/pallas_kernels.py:64"},
        "fused_eval": {"name": "fused_eval", "route": "cuda",
                       "source": "slslam_tpu_torch/csrc/fused_eval.cu",
                       "replaces": "slslam_tpu/ops/pallas_kernels.py:385"},
    }
    smi = phase0(dev)
    phase1(dev, rec)
    phase2(dev, rec)
    phase3(dev)
    phase4(dev, rec)
    if "jax" in sys.modules:
        raise AssertionError("chip_smoke imported jax")
    print(smi)
    log({"kernels": [rec["segment_sum"], rec["fused_eval"]]})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
