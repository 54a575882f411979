"""The JAX package's band on the scale-LC workload cut short, on the CPU.

tools/scale_lc.py's workload (the village, 3.35 orbits, every frame a
keyframe) at --frames N through the JAX package's ``BatchSlamLC`` once (a
cold run, as chip_smoke.py phase 9 (d) runs the port's tool), float64 on
the CPU, for each replay / post-pass random seed (``SlamConfig.rseed``) of
--seeds: closures and the odometry and final ATEs.  Their spread is the
band the port's run on the card is held to.

Usage:  python tools/jax_scale_lc_reference.py [--frames 340]
            [--seeds 4 5 6 7]
Prints one JSON line per seed, then one with the band.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np


def workload(num_frames, orbits=3.35, dtype="float64"):
    """tools/scale_lc.py's workload (:59-88): (config, frames, ground-truth
    poses, descriptor source, vocabulary, VocTreeParams)."""
    from slslam_tpu.config import SlamConfig
    from slslam_tpu.loopclosure import build_vocabulary
    from slslam_tpu.loopclosure.voctree import VocTreeParams
    from slslam_tpu.sim import (SegmentDescriptorSource, StereoLineRenderer,
                                TrackIdAssigner, village_segments,
                                village_trajectory)
    cfg = dataclasses.replace(
        SlamConfig(), compute_dtype=dtype, kf_rot_thr=1e-9,
        kf_tr_thr=1e-9, obs_buckets=(64, 80, 128, 256, 512, 1024, 2048))
    segs = village_segments(n_houses=6, ring_radius=9.0)
    poses = village_trajectory(num_frames=num_frames, arc=orbits * np.pi,
                               orbit_radius=3.8)
    ren = StereoLineRenderer(segs, cfg.camera, noise_px=0.3, seed=1)
    assigner = TrackIdAssigner(max_gap=5)
    src = SegmentDescriptorSource(assigner, len(segs), noise=0.01, seed=7)
    frames = [assigner.assign(i, ren.observe(T)) for i, T in enumerate(poses)]
    rng0 = np.random.default_rng(0)
    samples = np.concatenate([
        src.base + rng0.standard_normal(src.base.shape).astype(np.float32)
        * 0.02 for _ in range(3)])
    samples /= np.linalg.norm(samples, axis=1, keepdims=True)
    vocab = build_vocabulary(samples, seed=0, kmeans_iters=2)
    params = VocTreeParams(non_consider_recent=10, consider_seq_length=4,
                           threshold=0.25, num_avg_words=30)
    return cfg, frames, poses, src, vocab, params


def run_seed(num_frames, rseed):
    from slslam_tpu.engine.batch_lc import BatchSlamLC
    from slslam_tpu.loopclosure import VocTree
    from slslam_tpu.loopclosure.batch import BatchPlaceRecognizer
    cfg, frames, poses, src, vocab, params = workload(num_frames)
    cfg = dataclasses.replace(cfg, rseed=rseed)
    rec = BatchPlaceRecognizer(VocTree(vocab, params), min_matches=8,
                               min_similarity=0.8)
    eng = BatchSlamLC(cfg, recognizer=rec, descriptor_source=src,
                      refine=True, refine_rounds=2, overlap_descriptors=True)
    t0 = time.perf_counter()
    res = eng.run(frames)
    wall = time.perf_counter() - t0
    kfi = np.flatnonzero(np.asarray(res.base.is_kf))
    T0 = poses[kfi[0]]
    gt = [(poses[i] @ T0.inv()).inv() for i in kfi]

    def ate(traj):
        return float(np.mean([np.linalg.norm(a.t - b.t)
                              for a, b in zip(traj, gt)]))

    return {"frames": num_frames, "rseed": rseed, "wall_s": wall,
            "num_loop_closures": res.stats["num_loop_closures"],
            "ate_odometry_m": ate(res.base.trajectory),
            "ate_final_m": ate(res.trajectory),
            "refine_pick": res.stats.get("refine_pick")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=340)
    ap.add_argument("--seeds", type=int, nargs="+", default=[4, 5, 6, 7])
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    runs = []
    for rseed in args.seeds:
        runs.append(run_seed(args.frames, rseed))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({
        "frames": args.frames, "seeds": args.seeds,
        "closures": [r["num_loop_closures"] for r in runs],
        "final_over_odometry": [r["ate_final_m"] / r["ate_odometry_m"]
                                for r in runs],
        "ate_final_max_m": max(r["ate_final_m"] for r in runs)}))


if __name__ == "__main__":
    main()
