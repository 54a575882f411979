"""The global refine's reference band on the CPU: the JAX package's replay
and refine of one bench seed in float64, and the PyTorch port's refine of
the same replayed trajectory, also on the CPU in float64.

    python tools/jax_refine_reference.py [--seed 4] [--frames 400]

The workload and configuration are bench.py's batch mode (house world,
wave trajectory, 0.2 px, every frame a keyframe, 80-row buckets), with
``rounds=3`` as bench.py's refine.  Prints one JSON line: the JAX replay's
raw ATE, the JAX refine's refined ATE, LM iterations and wall, and the
same for the port's refine (CPU twins of its kernels) with the largest
pose difference between the two refines.  All of it is CPU work: the
walls say nothing of any accelerator.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    from slslam_tpu.config import SlamConfig
    from slslam_tpu.engine.batch import BatchSlam
    from slslam_tpu.engine.refine import global_refine
    from slslam_tpu.sim import (StereoLineRenderer, house_segments,
                                wave_trajectory)
    from slslam_tpu_torch import hostgeom as thost
    from slslam_tpu_torch.config import SlamConfig as TSlamConfig
    from slslam_tpu_torch.engine.refine import global_refine as t_refine

    kw = dict(compute_dtype="float64", kf_rot_thr=1e-9, kf_tr_thr=1e-9,
              obs_buckets=(80, 2048), line_buckets=(80, 2048),
              corr_buckets=(80, 256))
    cfg = dataclasses.replace(SlamConfig(), **kw)
    poses = wave_trajectory(num_frames=400)[:args.frames]
    ren = StereoLineRenderer(house_segments(), cfg.camera, noise_px=0.2,
                             seed=args.seed)
    frames = [ren.observe(T) for T in poses]

    def ate(traj):
        T0 = poses[0]
        return float(np.mean([np.linalg.norm(T.t - (G @ T0.inv()).inv().t)
                              for T, G in zip(traj, poses)]))

    t0 = time.perf_counter()
    res = BatchSlam(cfg).run(frames)
    replay_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = global_refine(frames, res.is_kf, res.trajectory, config=cfg,
                        rounds=args.rounds)
    refine_s = time.perf_counter() - t0

    torch.set_num_threads(2)
    traj = [thost.Pose(T.R, T.t) for T in res.trajectory]
    t0 = time.perf_counter()
    tref = t_refine(frames, res.is_kf, traj,
                    config=dataclasses.replace(TSlamConfig(), **kw),
                    rounds=args.rounds, device="cpu")
    port_s = time.perf_counter() - t0
    print(json.dumps({
        "what": "CPU, float64: JAX replay + JAX refine; port refine of the "
                "same trajectory",
        "seed": args.seed, "frames": args.frames, "rounds": args.rounds,
        "kf": res.kf_count, "ate_raw_m": ate(res.trajectory),
        "jax_replay_s": replay_s,
        "jax": {"ate_refined_m": ate(ref.trajectory),
                "iterations": ref.iterations, "wall_s": refine_s,
                "initial_cost": ref.initial_cost,
                "final_cost": ref.final_cost},
        "port": {"ate_refined_m": ate(tref.trajectory),
                 "iterations": tref.iterations, "wall_s": port_s,
                 "initial_cost": tref.initial_cost,
                 "final_cost": tref.final_cost},
        "max_pose_diff_m": max(float(np.linalg.norm(a.t - b.t))
                               for a, b in zip(ref.trajectory,
                                               tref.trajectory)),
        "num_lines": ref.num_lines, "num_obs": ref.num_obs}))


if __name__ == "__main__":
    main()
