"""Real-sequence proxy validation on the port: the reference's it(bt)3f /
olympic4f / myungdong keyframe motions replayed through matched-scale
synthetic worlds.

The port's counterpart of tools/real_proxy.py (which runs the JAX
package): the committed keyframe trajectories
(matlab_script/traj_slslam_*_basize10_wolc.txt, read from
``slslam_tpu_torch/sim/street.py``'s ``REFERENCE_DIR`` or --ref-dir) are
replayed as exact ground-truth motion through corridor and street line
worlds at each sequence's scale, with the same track churn and optional
association outliers, and the port's pipeline (``BatchSlam`` then the
global refine, or with --lc ``BatchSlamLC`` with voctree recognition,
PGO and the merged refine) reports ATE against ground truth, with the JAX
tool's JSON keys.  float32 on the card, float64 on the CPU.

Usage:
    python3 tools/torch_real_proxy.py                   # all three, card
    python3 tools/torch_real_proxy.py --seq itbt3f --max-frames 40 \\
        --device cpu
    python3 tools/torch_real_proxy.py --seq myungdong --lc
Prints one JSON line per sequence.
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


def run_sequence(seq, args):
    """One sequence (real_proxy.py:38-151) on ``args.device``."""
    import torch
    from slslam_tpu_torch import resolve_device
    from slslam_tpu_torch.config import SlamConfig
    from slslam_tpu_torch.engine.batch import BatchSlam
    from slslam_tpu_torch.engine.refine import global_refine
    from slslam_tpu_torch.sim.street import real_proxy_workload
    from slslam_tpu_torch.sim.tracks import TrackIdAssigner

    dev = resolve_device(args.device)
    dtype = "float64" if dev.type == "cpu" else "float32"
    interp = not args.no_interp
    over = {}
    if args.max_num_iter:
        # the reference's own benchmark sweeps --max_num_iter in {10, 1000}
        over["max_num_iter"] = args.max_num_iter
    if interp:
        # video-rate replay: the engine runs its own keyframe gates
        cfg = dataclasses.replace(SlamConfig(), compute_dtype=dtype, **over)
    else:
        # raw keyframe replay: every input pose is a keyframe
        cfg = dataclasses.replace(SlamConfig(), compute_dtype=dtype,
                                  kf_rot_thr=1e-9, kf_tr_thr=1e-9, **over)

    assigner = TrackIdAssigner(max_gap=5)
    frames, poses_gt, segs, stats = real_proxy_workload(
        seq, max_frames=args.max_frames, noise_px=args.noise_px,
        outlier_frac=args.outlier_frac, seed=args.seed, interpolate=interp,
        assigner=assigner, ref_dir=args.ref_dir)

    lc_res = eng = None
    t0 = time.perf_counter()
    if args.lc:
        # the wlc configuration: every sequence returns to its start
        from slslam_tpu_torch.engine.batch_lc import BatchSlamLC
        from slslam_tpu_torch.loopclosure import (PlaceRecognizer, VocTree,
                                                  VocTreeParams,
                                                  build_vocabulary)
        from slslam_tpu_torch.sim.tracks import SegmentDescriptorSource
        desc_src = SegmentDescriptorSource(assigner, len(segs), noise=0.01,
                                           seed=args.seed + 7)
        rng0 = np.random.default_rng(0)
        samples = np.concatenate([
            desc_src.base + rng0.standard_normal(
                desc_src.base.shape).astype(np.float32) * 0.02
            for _ in range(4)])
        samples /= np.linalg.norm(samples, axis=1, keepdims=True)
        vocab = build_vocabulary(samples, seed=0, kmeans_iters=2)
        params = VocTreeParams(non_consider_recent=30,
                               consider_seq_length=4, threshold=0.25,
                               num_avg_words=30)
        rec = PlaceRecognizer(VocTree(vocab, params, device=dev),
                              min_matches=8, min_similarity=0.8)
        eng = BatchSlamLC(cfg, recognizer=rec, descriptor_source=desc_src,
                          refine=True, refine_rounds=args.refine_rounds,
                          device=dev)
        lc_res = eng.run(frames)
        res, traj_final = lc_res.base, lc_res.trajectory
    else:
        res = BatchSlam(cfg, device=dev).run(frames)
        traj_final = global_refine(frames, res.is_kf, res.trajectory,
                                   config=cfg, device=dev).trajectory
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    kf_idx = np.flatnonzero(np.asarray(res.is_kf))

    def ate(traj):
        T0 = poses_gt[kf_idx[0]]
        gt = [(poses_gt[i] @ T0.inv()).inv() for i in kf_idx]
        return float(np.mean([np.linalg.norm(T.t - g.t)
                              for T, g in zip(traj, gt)]))

    path_len = float(np.sum(np.linalg.norm(
        np.diff(np.stack([T.inv().t for T in poses_gt]), axis=0), axis=1)))
    out = dict(stats)
    out.update(
        platform="gpu" if dev.type == "cuda" else dev.type,
        keyframes=res.kf_count,
        path_len_m=path_len,
        wall_s=wall,
        ate_raw_m=ate(res.trajectory),
        ate_refined_m=ate(traj_final),
        ate_refined_pct_of_path=100.0 * ate(traj_final) / path_len,
        avg_ba_iterations=res.stats["avg_num_iterations"],
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
    )
    if lc_res is not None:
        out.update(
            num_loop_candidates=lc_res.stats.get("num_loop_candidates"),
            num_loop_spans=lc_res.stats.get("num_loop_spans"),
            num_loop_closures=lc_res.stats["num_loop_closures"],
            num_merged_tracks=lc_res.stats["num_merged_tracks"],
            refine_pick=lc_res.stats.get("refine_pick"),
            refine_loop_frac=lc_res.stats.get("refine_loop_frac"),
            recognizer=dict(getattr(eng.recognizer, "stats", {})),
        )
    print(json.dumps(out))
    return out


def parser():
    from slslam_tpu_torch.sim.street import REFERENCE_DIR
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", default=None,
                    help="itbt3f / olympic4f / myungdong (default: all)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--noise-px", type=float, default=0.5)
    ap.add_argument("--outlier-frac", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-num-iter", type=int, default=0,
                    help="windowed-BA LM iteration cap (the reference "
                         "sweeps 10 and 1000; 0 = config default)")
    ap.add_argument("--no-interp", action="store_true",
                    help="replay raw keyframe poses instead of video-rate "
                         "interpolation")
    ap.add_argument("--lc", action="store_true",
                    help="wlc configuration: voctree place recognition + "
                         "loop closure + PGO + merged global refine")
    ap.add_argument("--refine-rounds", type=int, default=2,
                    help="global-refine rounds on the wlc path")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the twins)")
    ap.add_argument("--ref-dir", default=REFERENCE_DIR,
                    help="directory of the reference's trajectory files")
    return ap


def main(argv=None):
    from slslam_tpu_torch.sim.street import SEQUENCES
    args = parser().parse_args(argv)
    for seq in [args.seq] if args.seq else list(SEQUENCES):
        run_sequence(seq, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
