"""The global refine's reference band on the CPU: the JAX package's replay
and refine of one bench seed, and the PyTorch port's refine of the same
replayed trajectory, also on the CPU.

    python tools/jax_refine_reference.py [--seed 4] [--frames 400]
                                         [--jax-dtype float64]
                                         [--dtype float64] [--witnesses 0]

The workload and configuration are bench.py's batch mode (house world,
wave trajectory, 0.2 px, every frame a keyframe, 80-row buckets), with
``rounds=3`` as bench.py's refine, on the CG path as the card runs it
(for fewer than 129 frames each package would pick its dense path on
the CPU).  JAX's replay and refine run in
``--jax-dtype`` (float32 without JAX's x64 mode, as on its TPU); the
port's refine (CPU twins of its kernels) in ``--dtype``.  Prints one JSON
line: the JAX replay's raw ATE, each refine's refined ATE, LM and PCG
iterations (summed over the CG solves, and by solve) and wall, and the
largest pose difference between the two refines.  ``--witnesses N`` adds
N rounding witnesses: JAX's refine again from the same replayed
trajectory with every pose's (w, t) scaled by 1 + WITNESS_SCALE N(0, 1)
(numpy seeds 0 .. N-1), a few units in the last place of float32, so the
spread of JAX's own counts and ATEs under rounding alone.  All of it is
CPU work: the walls say nothing of any accelerator.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

# relative size of a witness's input change: ~4 float32 ulps
WITNESS_SCALE = 5e-7


def recorded(module, solves, pcg=None):
    """Wrap ``module.global_ba_cg`` so that each call appends its (LM, PCG)
    iterations to ``solves``: the PCG count from its stats (the port's),
    or the sum that ``pcg`` (a list) gathered during the call (JAX's,
    whose stats have none); returns the original."""
    orig = module.global_ba_cg

    def wrapped(*a, **k):
        start = 0 if pcg is None else len(pcg)
        out = orig(*a, **k)
        if pcg is None:
            n_cg = int(out[2].cg_iterations)
        else:
            int(out[2].iterations)
            jax.effects_barrier()
            n_cg = sum(pcg[start:])
        solves.append((int(out[2].iterations), n_cg))
        return out

    module.global_ba_cg = wrapped
    return orig


def count_jax_pcg(jcg):
    """Make each traced PCG step of the JAX package report its iteration
    count to the returned list, through ``jax.debug.callback`` inside the
    compiled solve (the arithmetic is unchanged).  Before the first
    solve is traced."""
    counts = []
    step = jcg._solve_step_cg

    def counted(*a, **k):
        out = step(*a, **k)
        jax.debug.callback(lambda n: counts.append(int(n)), out[4])
        return out

    jcg._solve_step_cg = counted
    return counts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--jax-dtype", default="float64",
                    choices=("float64", "float32"))
    ap.add_argument("--dtype", default="float64",
                    choices=("float64", "float32"))
    ap.add_argument("--witnesses", type=int, default=0)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    # the JAX package's float32 paths run as on its TPU, without x64 (its
    # LM loops keep float32 carries only then), so that replay is float32 too
    jax.config.update("jax_enable_x64", args.jax_dtype == "float64")

    from slslam_tpu.config import SlamConfig
    from slslam_tpu.engine.batch import BatchSlam
    from slslam_tpu.engine.refine import global_refine
    from slslam_tpu.hostgeom import Pose
    from slslam_tpu.ops import schur_cg as jcg
    from slslam_tpu.sim import (StereoLineRenderer, house_segments,
                                wave_trajectory)
    from slslam_tpu_torch import hostgeom as thost
    from slslam_tpu_torch.config import SlamConfig as TSlamConfig
    from slslam_tpu_torch.engine import refine as trefine

    kw = dict(kf_rot_thr=1e-9, kf_tr_thr=1e-9,
              obs_buckets=(80, 2048), line_buckets=(80, 2048),
              corr_buckets=(80, 256))
    cfg = dataclasses.replace(SlamConfig(), compute_dtype=args.jax_dtype,
                              **kw)
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

    def summary(ref, solves, wall):
        return {"ate_refined_m": ate(ref.trajectory),
                "iterations": ref.iterations,
                "pcg_iterations": sum(c for _, c in solves),
                "lm_iterations_by_solve": [i for i, _ in solves],
                "pcg_iterations_by_solve": [c for _, c in solves],
                "wall_s": wall, "initial_cost": ref.initial_cost,
                "final_cost": ref.final_cost}

    jax_pcg = count_jax_pcg(jcg)

    def jax_refine(traj):
        solves = []
        orig = recorded(jcg, solves, jax_pcg)
        try:
            t0 = time.perf_counter()
            ref = global_refine(frames, res.is_kf, traj, config=cfg,
                                rounds=args.rounds, method="cg")
            wall = time.perf_counter() - t0
        finally:
            jcg.global_ba_cg = orig
        return ref, summary(ref, solves, wall)

    ref, jax_out = jax_refine(res.trajectory)
    witnesses = []
    for w in range(args.witnesses):
        rng = np.random.default_rng(w)
        moved = [Pose.from_wt(T.wt() * (1 + WITNESS_SCALE
                                        * rng.standard_normal(6)))
                 for T in res.trajectory]
        witnesses.append(jax_refine(moved)[1])

    torch.set_num_threads(2)
    traj = [thost.Pose(T.R, T.t) for T in res.trajectory]
    solves = []
    orig = recorded(trefine, solves)
    try:
        t0 = time.perf_counter()
        tref = trefine.global_refine(
            frames, res.is_kf, traj,
            config=dataclasses.replace(TSlamConfig(),
                                       compute_dtype=args.dtype, **kw),
            rounds=args.rounds, method="cg", device="cpu")
        port_s = time.perf_counter() - t0
    finally:
        trefine.global_ba_cg = orig
    print(json.dumps({
        "what": f"CPU: JAX replay + JAX refine ({args.jax_dtype}); port "
                f"refine of the same trajectory ({args.dtype})",
        "seed": args.seed, "frames": args.frames, "rounds": args.rounds,
        "jax_dtype": args.jax_dtype, "port_dtype": args.dtype,
        "kf": res.kf_count, "ate_raw_m": ate(res.trajectory),
        "jax_replay_s": replay_s, "jax": jax_out,
        "jax_witnesses": witnesses, "witness_scale": WITNESS_SCALE,
        "port": summary(tref, solves, port_s),
        "max_pose_diff_m": max(float(np.linalg.norm(a.t - b.t))
                               for a, b in zip(ref.trajectory,
                                               tref.trajectory)),
        "num_lines": ref.num_lines, "num_obs": ref.num_obs}))


if __name__ == "__main__":
    main()
