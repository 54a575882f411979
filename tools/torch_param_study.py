"""Line-parameterization study on the port (the reference's
comp_ancdir_orthonorm analog).

The port's counterpart of tools/param_study.py (which runs the JAX
package): the house simulation (render seed 4) through the port's
interactive ``Slam`` across line parameterizations x noise levels x BA
window sizes, writing ``ba_result_<param>_err<e>_basize<b>.txt`` in the
reference's format (average LM iterations, total time, average initial
cost, average final cost; BASELINE.md section 1) and
``trajectory_<param>_err<e>_basize<b>.txt``, in the JAX tool's format
strings.  float32 on the card and float64 on the CPU, as the JAX tool picks
by platform.  ``aid`` lines run on the card through K2 by the chain rule
(``ops/kernels.py fused_eval_chart``).  The window solves run at
``SlamConfig``'s LM cap (the JAX tool takes no cap argument either).

Usage:
  python3 tools/torch_param_study.py --out /tmp/study --frames 120 \\
      --params orth aid --errors 0.2 0.6 1.0 --basizes 10 [--device cpu]
Prints one line per run as the JAX tool does, then one JSON line with
every run's numbers, the device and its nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np


def run_one(param, err_px, basize, frames, device="cuda", gumbel_hook=None):
    """One study run (param_study.py:35-74) on ``device``: the house along
    the wave over ``frames`` frames through ``Slam``.  ``gumbel_hook``:
    ``Slam``'s RANSAC noise (JAX's stream in the tests)."""
    import torch
    from slslam_tpu_torch import resolve_device
    from slslam_tpu_torch.config import SlamConfig
    from slslam_tpu_torch.engine import Slam
    from slslam_tpu_torch.evalio.traj import ate_position_error
    from slslam_tpu_torch.evalio.writers import trajectory_rows
    from slslam_tpu_torch.sim import (StereoLineRenderer, house_segments,
                                      wave_trajectory)

    dev = resolve_device(device)
    cfg = dataclasses.replace(
        SlamConfig(),
        compute_dtype="float64" if dev.type == "cpu" else "float32",
        line_param=param, ba_window_size=basize)
    poses_gt = wave_trajectory(num_frames=frames)
    ren = StereoLineRenderer(house_segments(), cfg.camera, noise_px=err_px,
                             seed=4)
    slam = Slam(cfg, device=dev, gumbel_hook=gumbel_hook)
    kf_frames = []
    t0 = time.perf_counter()
    for i, T in enumerate(poses_gt):
        if slam.process_frame(ren.observe(T), i):
            kf_frames.append(i)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    est = trajectory_rows(slam.trajectory())
    T0 = poses_gt[kf_frames[0]]
    gt = trajectory_rows([(poses_gt[i] @ T0.inv()).inv()
                          for i in kf_frames])
    n = max(slam.num_frames_processed, 1)
    return {
        "avg_iters": slam.sum_num_iteration / n,
        "total_time": wall,
        "avg_init_cost": slam.sum_init_cost / n,
        "avg_final_cost": slam.sum_final_cost / n,
        "ate": ate_position_error(est, gt),
        "est_rows": est,
        "keyframes": len(kf_frames),
        "dtype": cfg.compute_dtype,
    }


def write_result(out_dir, tag, r):
    """The reference's ba_result file and the trajectory file
    (param_study.py:89-99)."""
    with open(os.path.join(out_dir, f"ba_result_{tag}.txt"), "w") as f:
        f.write(f"Average number of iterations = {r['avg_iters']:.5f}\n")
        f.write(f"Total time = {r['total_time']:.4f}\n")
        f.write(f"Average initial costs = {r['avg_init_cost']:.6g}\n")
        f.write(f"Average final costs = {r['avg_final_cost']:.6g}\n")
    np.savetxt(os.path.join(out_dir, f"trajectory_{tag}.txt"),
               r["est_rows"][:, 1:7], delimiter="\t")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--params", nargs="+", default=["orth", "aid"])
    ap.add_argument("--errors", nargs="+", type=float, default=[0.2])
    ap.add_argument("--basizes", nargs="+", type=int, default=[10])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the twins "
                         "in float64)")
    args = ap.parse_args(argv)

    import torch
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    runs = {}
    for param in args.params:
        for err in args.errors:
            for basize in args.basizes:
                r = run_one(param, err, basize, args.frames, args.device)
                tag = f"{param}_err{err:.1f}_basize{basize}"
                write_result(args.out, tag, r)
                print(f"{tag}: iters {r['avg_iters']:.2f} "
                      f"time {r['total_time']:.1f}s ate {r['ate']:.4f}")
                runs[tag] = {k: v for k, v in r.items() if k != "est_rows"}
    out = {"frames": args.frames, "device": args.device, "runs": runs}
    if torch.device(args.device).type == "cuda":
        out["device"] = torch.cuda.get_device_name(0)
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
