"""Command-line driver of the PyTorch port.

    python -m slslam_tpu_torch.cli sim --frames 120 --noise-px 0.5 \\
        --out /tmp/run

The ``sim`` command of ``slslam_tpu.cli --engine batch`` with the same
flags: renders the house world along the wave trajectory (the port's copy
of the simulation, ``slslam_tpu_torch.sim``, render seed = --rseed),
replays it through the port's ``BatchSlam`` and writes the trajectory in
the reference's text format plus ``stats.json``.  ``--refine`` follows the
replay with the global bundle adjustment (``engine/refine.py``), records
its ``refine_*`` stats and ``refine_ate_m`` and writes
``trajectory_refined.txt``, as the JAX CLI does.  ``--device`` defaults to
``cuda``; ``--device cpu`` runs the plain twins.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np


def cmd_sim(args):
    import torch

    from .bench import ate
    from .config import SlamConfig
    from .engine.batch import BatchSlam
    from .engine.refine import global_refine
    from .evalio.writers import trajectory_rows, write_trajectory
    from .sim import StereoLineRenderer, house_segments, wave_trajectory

    cfg = dataclasses.replace(
        SlamConfig(), ba_window_size=args.ba_window_size,
        max_num_iter=args.max_num_iter, rseed=args.rseed,
        compute_dtype=args.dtype)
    poses_gt = wave_trajectory(num_frames=args.frames)
    ren = StereoLineRenderer(house_segments(), cfg.camera,
                             noise_px=args.noise_px, seed=args.rseed)
    frames = [ren.observe(T) for T in poses_gt]

    eng = BatchSlam(cfg, device=args.device)
    t0 = time.perf_counter()
    res = eng.run(frames)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    wall = time.perf_counter() - t0

    kf_idx = np.flatnonzero(res.is_kf)
    stats = dict(res.stats)
    stats["wall_s"] = wall
    stats["kf_per_s"] = res.kf_count / max(wall, 1e-9)
    stats["device"] = str(eng.device)
    stats["dtype"] = str(eng.dtype)
    if res.kf_count:
        stats["ate_m"] = ate(res.trajectory, [poses_gt[i] for i in kf_idx])
    print(f"replayed {len(frames)} frames -> {res.kf_count} keyframes in "
          f"{wall:.2f}s on {eng.device}")
    ref = None
    if args.refine and res.kf_count:
        # the JAX CLI's _refine_batch (slslam_tpu/cli.py:140-157)
        t0 = time.perf_counter()
        ref = global_refine(frames, res.is_kf, res.trajectory, config=cfg,
                            device=eng.device)
        stats["refine_wall_s"] = time.perf_counter() - t0
        stats["refine_iterations"] = ref.iterations
        stats["refine_initial_cost"] = ref.initial_cost
        stats["refine_final_cost"] = ref.final_cost
        stats["refine_num_cams"] = ref.num_cams
        stats["refine_num_obs"] = ref.num_obs
        stats["refine_ate_m"] = ate(ref.trajectory,
                                     [poses_gt[i] for i in kf_idx])
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        write_trajectory(os.path.join(args.out, "trajectory.txt"),
                         res.trajectory)
        if ref is not None:
            write_trajectory(os.path.join(args.out,
                                          "trajectory_refined.txt"),
                             ref.trajectory)
        if res.kf_count:
            T0 = poses_gt[kf_idx[0]]
            np.savetxt(os.path.join(args.out, "gt_trajectory.txt"),
                       trajectory_rows([(poses_gt[i] @ T0.inv()).inv()
                                        for i in kf_idx]), delimiter="\t")
        with open(os.path.join(args.out, "stats.json"), "w") as f:
            json.dump(stats, f, indent=2)
    for k, v in stats.items():
        print(f"  {k}: {v}")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(prog="slslam_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("sim", help="replay the simulated house world")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--noise-px", type=float, default=0.5)
    p.add_argument("--rseed", type=int, default=4,
                   help="seed of the renderer and of the RANSAC generator")
    p.add_argument("--ba-window-size", type=int, default=10)
    p.add_argument("--max-num-iter", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the twins)")
    p.add_argument("--refine", action="store_true",
                   help="follow the replay with one global bundle "
                        "adjustment over every keyframe")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--out", default=None, help="output directory")
    args = ap.parse_args(argv)
    if args.cmd == "sim":
        cmd_sim(args)


if __name__ == "__main__":
    main()
