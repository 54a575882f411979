"""1000-keyframe deferred loop closure on the port.

The port's counterpart of tools/scale_lc.py (which runs the JAX package):
the same workload, a long multi-revisit synthetic (several drifting orbits
of the village world, so recognition fires on every pass), through the
port's whole deferred pipeline (``BatchSlamLC``: replay, one-pass voctree
recognition with ``BatchPlaceRecognizer``, span solves, joint confirms,
PGO, the merged 2-round refine), with the same JSON keys: the wall
breakdown, closures, ATEs, the recognition pass's wall against timeline
length K (``recognize_sequence`` over prefixes), and the peak device
memory (``peak_hbm_mib``: ``torch.cuda.max_memory_allocated``).  The cold
run is the first run after the kernel build, the warm run the second, as
in the JAX tool (both share one descriptor source, whose noise stream runs
on).  float32 on the card, float64 on the CPU.

Usage:
    python3 tools/torch_scale_lc.py                 # one NVIDIA GPU
    python3 tools/torch_scale_lc.py --device cpu --frames 60 --no-prefixes
Prints one JSON line.
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

WALL_KEYS = ("wall_replay_s", "wall_recognition_s", "wall_span_rounds_s",
             "wall_joint_confirm_s", "num_joint_solves", "wall_pgo_s",
             "wall_refine_s")


def workload(num_frames=1000, orbits=3.35, dtype="float32"):
    """scale_lc.py's workload (:59-88): (config, frames, ground-truth
    poses, descriptor source, vocabulary, VocTreeParams)."""
    from slslam_tpu_torch.config import SlamConfig
    from slslam_tpu_torch.loopclosure import VocTreeParams, build_vocabulary
    from slslam_tpu_torch.sim import (SegmentDescriptorSource,
                                      StereoLineRenderer, TrackIdAssigner,
                                      village_segments, village_trajectory)
    cfg = dataclasses.replace(
        SlamConfig(), compute_dtype=dtype, kf_rot_thr=1e-9, kf_tr_thr=1e-9,
        # the JAX tool's workload-sized observation buckets (74 a frame ->
        # 80), small leading entries for the confirm stages' span problems
        obs_buckets=(64, 80, 128, 256, 512, 1024, 2048))
    segs = village_segments(n_houses=6, ring_radius=9.0)
    poses_gt = village_trajectory(num_frames=num_frames,
                                  arc=orbits * np.pi, orbit_radius=3.8)
    ren = StereoLineRenderer(segs, cfg.camera, noise_px=0.3, seed=1)
    assigner = TrackIdAssigner(max_gap=5)
    desc_src = SegmentDescriptorSource(assigner, len(segs), noise=0.01,
                                       seed=7)
    frames = [assigner.assign(i, ren.observe(T))
              for i, T in enumerate(poses_gt)]
    rng0 = np.random.default_rng(0)
    samples = np.concatenate([
        desc_src.base + rng0.standard_normal(
            desc_src.base.shape).astype(np.float32) * 0.02
        for _ in range(3)])
    samples /= np.linalg.norm(samples, axis=1, keepdims=True)
    vocab = build_vocabulary(samples, seed=0, kmeans_iters=2)
    params = VocTreeParams(non_consider_recent=10, consider_seq_length=4,
                           threshold=0.25, num_avg_words=30)
    return cfg, frames, poses_gt, desc_src, vocab, params


def run(num_frames=1000, orbits=3.35, prefixes=True, device="cuda",
        warm=True):
    """The tool's run: (the JSON record, the last run's BatchLCResult).
    The record's numbers are the last run's, as the JAX tool reports the
    warm run's; ``cold_run`` holds the cold run's closures and ATEs.
    ``warm=False`` stops after the cold run (``warm_s`` None)."""
    import torch
    from slslam_tpu_torch import resolve_device
    from slslam_tpu_torch.engine.batch_lc import BatchSlamLC
    from slslam_tpu_torch.loopclosure import BatchPlaceRecognizer, VocTree
    from slslam_tpu_torch.loopclosure.batch import recognize_sequence
    from slslam_tpu_torch.ops import kernels
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kernels.load_library()
        torch.cuda.reset_peak_memory_stats(dev)
    cfg, frames, poses_gt, desc_src, vocab, params = workload(
        num_frames, orbits, "float32" if cuda else "float64")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def one_run():
        tree = VocTree(vocab, params, device=dev)
        rec = BatchPlaceRecognizer(tree, min_matches=8, min_similarity=0.8)
        eng = BatchSlamLC(cfg, recognizer=rec, descriptor_source=desc_src,
                          refine=True, refine_rounds=2,
                          overlap_descriptors=True, device=dev)
        sync()
        t0 = time.perf_counter()
        res = eng.run(frames)
        sync()
        return tree, res, time.perf_counter() - t0

    tree, cold, cold_s = one_run()
    res, warm_s = cold, None
    if warm:
        _, res, warm_s = one_run()

    kfi = np.flatnonzero(np.asarray(res.base.is_kf))
    T0 = poses_gt[kfi[0]]
    gt = [(poses_gt[i] @ T0.inv()).inv() for i in kfi]

    def ate(traj):
        return float(np.mean([np.linalg.norm(a.t - b.t)
                              for a, b in zip(traj, gt)]))

    # the recognition pass's wall against K (a warm-up pass, then one timed)
    prefix_walls = {}
    if prefixes:
        kf_descs = [desc_src(int(f), sorted(frames[f])) for f in kfi]
        for K in (len(kfi) // 4, len(kfi) // 2, len(kfi)):
            recognize_sequence(tree, kf_descs[:K])
            sync()
            t0 = time.perf_counter()
            recognize_sequence(tree, kf_descs[:K])
            sync()
            prefix_walls[K] = time.perf_counter() - t0

    nkf = res.base.kf_count
    out = {
        "platform": "gpu" if cuda else dev.type,
        "frames": num_frames,
        "keyframes": nkf,
        "cold_s": cold_s,
        "warm_s": warm_s,
        "kf_per_s_warm": nkf / warm_s if warm_s else None,
        "num_loop_candidates": res.stats["num_loop_candidates"],
        "num_loop_spans": res.stats["num_loop_spans"],
        "num_loop_closures": res.stats["num_loop_closures"],
        "num_merged_tracks": res.stats["num_merged_tracks"],
        "ate_odometry_m": ate(res.base.trajectory),
        "ate_final_m": ate(res.trajectory),
        "wall_breakdown": {k: res.stats.get(k) for k in WALL_KEYS},
        "recognition_scan_wall_by_K": prefix_walls,
        "peak_hbm_mib": (torch.cuda.max_memory_allocated(dev) / 2**20
                         if cuda else None),
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "dtype": cfg.compute_dtype,
        "kf_per_s_cold": nkf / cold_s,
        "refine_pick": res.stats.get("refine_pick"),
        "wall_confirm_stages": res.stats.get("wall_confirm_stages"),
        # the cold run's outcome beside the warm run's (the descriptor
        # source's noise stream runs on between them)
        "cold_run": {"num_loop_closures": cold.stats["num_loop_closures"],
                     "ate_odometry_m": ate(cold.base.trajectory),
                     "ate_final_m": ate(cold.trajectory)},
    }
    if cuda:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    return out, res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--cpu", action="store_true",
                    help="the JAX tool's flag: the same as --device cpu")
    ap.add_argument("--orbits", type=float, default=3.35,
                    help="orbit turns (every pass past the first revisits)")
    ap.add_argument("--no-prefixes", action="store_true",
                    help="skip the recognition-cost-vs-K prefix curve")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the twins)")
    args = ap.parse_args(argv)
    out, _ = run(args.frames, args.orbits, not args.no_prefixes,
                 "cpu" if args.cpu else args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
