"""Loop-closure mode's reference on the CPU: the JAX package's replay and
deferred-LC post-pass of bench.py's lc workload, and the PyTorch port's
post-pass on the same replayed result.

    python tools/jax_lc_reference.py [--frames 170] [--arc 2.7]
                                     [--dtype float64] [--noise jax]
                                     [--jax-dtype float64] [--rseed 4]

The workload and configuration are bench.py's lc mode (village of 6
houses, ring radius 9, orbit radius 3.8, 0.3 px, render seed 1,
descriptor seed 7, every frame a keyframe, the village buckets), cut to
``--frames`` over an arc of ``--arc`` pi.  Both post-passes read the same
descriptors (every frame's, computed once in frame order).  The port's
post-pass runs on the CPU (its kernels' twins) in ``--dtype``; its span
solves take JAX's RANSAC noise (``--noise jax``: fold_in(PRNGKey(rseed ^
0x10C), keyframe), drawn in that dtype) or its own generator (``--noise
port``).  Prints one JSON line: both post-passes' closures, merges, PGO
iterations and refine pick, the odometry and final ATE of each, and the
largest pose difference between the two final trajectories.  JAX's
replay and post-pass run in ``--jax-dtype`` (float32 without JAX's x64
mode, as on its TPU).  ``--rseed`` sets both post-passes'
``rseed`` (the span solves' RANSAC noise and the joint alignment's RANSAC;
the replay keeps the configuration's), so a few values of it give the band
that the post-pass's random streams span.  All of it is CPU work: the
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
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=170)
    ap.add_argument("--arc", type=float, default=2.7)
    ap.add_argument("--dtype", default="float64",
                    choices=("float64", "float32"))
    ap.add_argument("--noise", default="jax", choices=("jax", "port"))
    ap.add_argument("--jax-dtype", default="float64",
                    choices=("float64", "float32"))
    ap.add_argument("--rseed", type=int, default=None)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    # the JAX package's float32 paths run as on its TPU, without x64 (its
    # LM loops keep float32 carries only then), so that replay is float32 too
    jax.config.update("jax_enable_x64", args.jax_dtype == "float64")

    from slslam_tpu.config import SlamConfig
    from slslam_tpu.engine import batch_lc as jlc
    from slslam_tpu.engine.batch import BatchSlam
    from slslam_tpu.loopclosure import VocTree as JTree
    from slslam_tpu.loopclosure.batch import BatchPlaceRecognizer as JRec
    from slslam_tpu.loopclosure.voctree import VocTreeParams as JParams
    from slslam_tpu_torch import bench
    from slslam_tpu_torch.engine.batch import BatchResult
    from slslam_tpu_torch.hostgeom import Pose

    tcfg = bench.lc_config("float64")
    frames, poses, src, _, vocab, params = bench.lc_workload(
        tcfg, args.frames, args.arc)
    jcfg = dataclasses.replace(
        SlamConfig(), **{f.name: getattr(tcfg, f.name)
                         for f in dataclasses.fields(tcfg)
                         if f.name != "camera"})
    jcfg = dataclasses.replace(jcfg, compute_dtype=args.jax_dtype)
    t0 = time.perf_counter()
    res = BatchSlam(jcfg).run(frames)
    t_replay = time.perf_counter() - t0
    pre = [src(i, sorted(fr)) for i, fr in enumerate(frames)]

    class Replayed:
        def dispatch(self, frames, **kw):
            return None

        def collect(self, handle):
            return res

    rseed = jcfg.rseed if args.rseed is None else args.rseed
    jpost = dataclasses.replace(jcfg, rseed=rseed)
    eng = jlc.BatchSlamLC(jpost, recognizer=JRec(JTree(vocab, JParams(
        **dataclasses.asdict(params)))),
        descriptor_source=lambda i, f: pre[i], refine=True, refine_rounds=2)
    eng._batch = Replayed()
    t0 = time.perf_counter()
    jout = eng.run(frames)
    t_jax = time.perf_counter() - t0

    hook = None
    if args.noise == "jax":
        base = jax.random.PRNGKey(rseed ^ 0x10C)
        jdt = jnp.float64 if args.dtype == "float64" else jnp.float32

        def hook(k, H, N):
            return torch.as_tensor(np.array(jax.random.gumbel(
                jax.random.fold_in(base, k), (H, N), jdt)))

    pcfg = dataclasses.replace(bench.lc_config(args.dtype), rseed=rseed)
    tres = BatchResult([Pose(T.R, T.t) for T in res.trajectory],
                       res.edges_wt, res.is_kf, res.kf_count, [],
                       dict(res.stats), res.per_frame)
    t0 = time.perf_counter()
    tout = bench.lc_engine(pcfg, src, vocab, params, "cpu",
                           gumbel_hook=hook).post_pass(frames, tres,
                                                       pre_desc=pre)
    t_port = time.perf_counter() - t0

    gt = [poses[i] for i in np.flatnonzero(res.is_kf)]
    keys = ("num_loop_candidates", "num_loop_spans", "num_loop_closures",
            "num_merged_tracks", "pgo_iterations", "num_joint_solves",
            "refine_pick")
    print(json.dumps({
        "frames": args.frames, "arc_pi": args.arc, "port_dtype": args.dtype,
        "port_noise": args.noise, "jax_dtype": args.jax_dtype,
        "rseed": rseed,
        "jax": {k: jout.stats[k] for k in keys},
        "port": {k: tout.stats[k] for k in keys},
        "same_merges": tout.merged_fids == jout.merged_fids,
        "ate_odometry_m": bench.ate(res.trajectory, gt),
        "ate_final_jax_m": bench.ate(jout.trajectory, gt),
        "ate_final_port_m": bench.ate(tout.trajectory, gt),
        "max_traj_diff_m": max(float(np.linalg.norm(a.t - b.t)) for a, b
                               in zip(jout.trajectory, tout.trajectory)),
        "refine_iterations": {"jax": jout.refined.iterations,
                              "port": tout.refined.iterations},
        "cpu_wall_s": {"jax_replay": t_replay, "jax_post_pass": t_jax,
                       "port_post_pass": t_port}}))


if __name__ == "__main__":
    main()
