"""Benchmark of the port: keyframes per second of replay + global refine.

    python3 -m slslam_tpu_torch.bench                  # one NVIDIA GPU
    BENCH_MODE=lc python3 -m slslam_tpu_torch.bench    # loop closure
    BENCH_MODE=interactive python3 -m slslam_tpu_torch.bench

The workload, configuration and JSON contract of the repository's
``bench.py`` in its default batch mode (bench.py:93-251), run on the port:
the house world along the wave trajectory, 400 frames, render seeds 4-8,
0.2 px noise, every frame a keyframe, 80-row buckets, float32 on the card;
each seed is replayed (``BatchSlam``) and then globally refined
(``global_refine``, 3 rounds).  The port has no asynchronous device queue
to overlap one seed's refine with the next seed's replay, so the seeds run
in serial, replay then refine, and the ``mode`` string says so.

Prints one JSON line on stdout,

    {"metric": "keyframes_per_s", "value": N, "unit": "kf/s",
     "vs_baseline": R}

where the baseline is the reference's 400 keyframes in 35.85 s
(bench.py:40), and one line on stderr with ``worst_seed_ate_refined_m``,
``worst_seed_ate_raw_m``, ``per_seed``, ``avg_ba_iterations``,
``num_landmarks``, ``cold_s`` and ``warm_walls_s``, plus the card's name
and each pass's replay and refine seconds.  The first pass is ``cold_s``;
warm passes repeat while the wall stays within ``BENCH_BUDGET_S`` (default
480 s), at most three, and the rate is the fastest warm pass's (as
bench.py:209-233).  Without a CUDA device it raises.

``BENCH_MODE=lc`` runs bench.py's loop-closure workload instead
(bench.py:344-463): the village of 6 houses on a ring of radius 9, 170
frames over an arc of 2.7 pi at orbit radius 3.8, 0.3 px noise, render seed
1, descriptor seed 7, every frame a keyframe, bench.py's village buckets,
float32 on the card; ``BatchSlamLC`` with the batched recognizer, the
merged 2-round refine and ``overlap_descriptors=True``.  It prints the
same two lines; the stderr record is bench.py's lc contract (keyframes,
cold and warm seconds, closures, merged tracks, odometry and final ATE,
``wall_breakdown``, ``wall_confirm_stages``) plus the card's name and
``refine_pick``.  In batch mode the lc measurement is appended as a stderr
``lc_keyframes_per_s`` line when at least 200 s of the budget remain, as
bench.py:555-566 does; ``BENCH_LC=0`` turns it off.

``BENCH_MODE=interactive`` runs bench.py's interactive workload
(bench.py:466-522) through the port's per-frame ``Slam``: the house, render
seed 4, 110 frames of which the first 25 warm up, every frame a keyframe,
buckets obs (2048,), cams (48,), lines (128,), correspondences (128,),
float32 on the card.  The rate is 1 / the median measured frame time; the
stderr record carries bench.py's keys (``mean_rate_kf_s``,
``median_frame_ms``, ``ba_mean_ms``, ``vo_mean_ms``,
``avg_ba_iterations``, ``keyframes``, ``measured_frames``) plus the card's
name and the engine's ``post_processing()`` stage means.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

BASELINE_KF_PER_S = 400.0 / 35.85
SEEDS = (4, 5, 6, 7, 8)
NUM_FRAMES = 400
ROUNDS = 3


def bench_config(dtype):
    """bench.py's batch configuration (bench.py:115-120)."""
    from .config import SlamConfig
    return dataclasses.replace(
        SlamConfig(), compute_dtype=dtype, kf_rot_thr=1e-9, kf_tr_thr=1e-9,
        obs_buckets=(80, 2048), line_buckets=(80, 2048),
        corr_buckets=(80, 256))


def workload(cfg, num_frames, seed):
    """(frames, ground-truth poses) of one render seed (bench.py:56-63)."""
    from .sim import StereoLineRenderer, house_segments, wave_trajectory
    poses = wave_trajectory(num_frames=400)[:num_frames]
    ren = StereoLineRenderer(house_segments(), cfg.camera, noise_px=0.2,
                             seed=seed)
    return [ren.observe(T) for T in poses], poses


def ate(traj, poses_gt):
    """Mean position error against ground truth, both rooted at their
    first pose (bench.py:66-75; the lc mode passes its keyframes' poses,
    bench.py:414-418)."""
    T0 = poses_gt[0]
    return float(np.mean([np.linalg.norm(T.t - (G @ T0.inv()).inv().t)
                          for T, G in zip(traj, poses_gt)]))


def emit(value, extra):
    print(json.dumps(extra), file=sys.stderr)
    print(json.dumps({"metric": "keyframes_per_s", "value": round(value, 3),
                      "unit": "kf/s",
                      "vs_baseline": round(value / BASELINE_KF_PER_S, 3)}))


def bench_batch(device="cuda", num_frames=NUM_FRAMES, seeds=SEEDS,
                dtype="float32", budget_s=480.0):
    """Replay + refine of every seed, timed; prints the two JSON lines and
    returns (kf/s, the stderr record)."""
    from . import resolve_device
    from .engine.batch import BatchSlam
    from .engine.refine import global_refine

    t_start = time.perf_counter()
    dev = resolve_device(device)
    cfg = bench_config(dtype)
    workloads = [workload(cfg, num_frames, s) for s in seeds]
    eng = BatchSlam(cfg, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def one_pass():
        t0 = time.perf_counter()
        results, refs, replay_s, refine_s = [], [], [], []
        for frames, _ in workloads:
            t1 = time.perf_counter()
            res = eng.run(frames)
            sync()
            t2 = time.perf_counter()
            refs.append(global_refine(frames, res.is_kf, res.trajectory,
                                      config=cfg, rounds=ROUNDS,
                                      device=dev))
            sync()
            results.append(res)
            replay_s.append(t2 - t1)
            refine_s.append(time.perf_counter() - t2)
        return results, refs, {"replay_s": replay_s, "refine_s": refine_s,
                               "total_s": time.perf_counter() - t0}

    t0 = time.perf_counter()
    results, refs, breakdown = one_pass()
    cold_s = time.perf_counter() - t0
    walls, passes = [], [breakdown]
    est = cold_s
    while (time.perf_counter() - t_start) + est < budget_s and len(walls) < 3:
        t0 = time.perf_counter()
        results, refs, breakdown = one_pass()
        walls.append(time.perf_counter() - t0)
        passes.append(breakdown)
        est = 1.1 * min(walls)
    wall = min(walls) if walls else cold_s

    per_seed = {}
    for s, res, ref, (_, poses) in zip(seeds, results, refs, workloads):
        per_seed[s] = {"kf": res.kf_count,
                       "ate_raw": ate(res.trajectory, poses),
                       "ate_refined": ate(ref.trajectory, poses),
                       "refine_iterations": ref.iterations}
    kf_per_s = sum(r.kf_count for r in results) / wall
    extra = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "dtype": dtype,
        "mode": "batch+refine (serial seeds: replay, then refine; no "
                "asynchronous device queue)",
        "seeds_measured": len(seeds),
        "keyframes_per_run": results[0].kf_count,
        "cold_s": cold_s,
        "warm_walls_s": walls,
        "wall_breakdown": passes,
        "worst_seed_ate_refined_m": max(r["ate_refined"]
                                        for r in per_seed.values()),
        "worst_seed_ate_raw_m": max(r["ate_raw"] for r in per_seed.values()),
        "per_seed": per_seed,
        "avg_ba_iterations": float(np.mean(
            [r.stats["avg_num_iterations"] for r in results])),
        "num_landmarks": results[0].stats["num_landmarks"],
    }
    emit(kf_per_s, extra)
    return kf_per_s, extra


def lc_config(dtype):
    """bench.py's lc configuration (bench.py:373-379): every frame a
    keyframe, the village-sized buckets."""
    from .config import SlamConfig
    return dataclasses.replace(
        SlamConfig(), compute_dtype=dtype, kf_rot_thr=1e-9, kf_tr_thr=1e-9,
        obs_buckets=(64, 80, 128, 256, 512, 1024, 2048),
        line_buckets=(32, 64, 128, 320, 512, 1024, 2048),
        corr_buckets=(80, 256))


LC_FRAMES = 170
LC_ARC = 2.7      # x pi


def lc_workload(cfg, num_frames=LC_FRAMES, arc=LC_ARC, orbit_radius=3.8):
    """bench.py's lc workload (bench.py:381-401): (frames, ground-truth
    poses, descriptor source, track assigner, vocabulary, VocTreeParams).
    The vocabulary is trained here, outside any timed region."""
    from .loopclosure import VocTreeParams, build_vocabulary
    from .sim import (SegmentDescriptorSource, StereoLineRenderer,
                      TrackIdAssigner, village_segments, village_trajectory)
    segs = village_segments(n_houses=6, ring_radius=9.0)
    poses = village_trajectory(num_frames=num_frames, arc=arc * np.pi,
                               orbit_radius=orbit_radius)
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
    return frames, poses, src, assigner, vocab, params


def lc_engine(cfg, src, vocab, params, device, **kw):
    """bench.py's lc engine (bench.py:403-412) on ``device``."""
    from .engine.batch_lc import BatchSlamLC
    from .loopclosure import BatchPlaceRecognizer, VocTree
    rec = BatchPlaceRecognizer(VocTree(vocab, params, device=device),
                               min_matches=8, min_similarity=0.8)
    return BatchSlamLC(cfg, recognizer=rec, descriptor_source=src,
                       refine=True, refine_rounds=2,
                       overlap_descriptors=True, device=device, **kw)


LC_WALLS = ("wall_replay_s", "wall_recognition_s", "wall_desc_s",
            "wall_recog_scan_s", "wall_span_rounds_s", "wall_joint_confirm_s",
            "wall_pgo_s", "wall_refine_s")


def bench_lc(device="cuda", dtype="float32", budget_s=480.0, t_start=None,
             as_extra=False, num_frames=LC_FRAMES, arc=LC_ARC):
    """The loop-closure workload, timed (bench.py:344-463): a cold run,
    then warm runs while the budget allows, at most three.  Prints bench.py's
    two lines, or with ``as_extra`` one stderr ``lc_keyframes_per_s`` line;
    returns (kf/s, the record)."""
    from . import resolve_device
    t_start = time.perf_counter() if t_start is None else t_start
    dev = resolve_device(device)
    cfg = lc_config(dtype)
    frames, poses, src, _, vocab, params = lc_workload(cfg, num_frames, arc)

    def one_run():
        t0 = time.perf_counter()
        res = lc_engine(cfg, src, vocab, params, dev).run(frames)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return res, time.perf_counter() - t0

    res, cold_s = one_run()
    walls = []
    est = 0.3 * cold_s + 10.0
    while (time.perf_counter() - t_start) + est < budget_s \
            and len(walls) < 3:
        res, wall = one_run()
        walls.append(wall)
        est = 1.1 * min(walls)
    warm_s = min(walls) if walls else cold_s
    gt = [poses[i] for i in np.flatnonzero(np.asarray(res.base.is_kf))]
    nkf = res.base.kf_count
    kf_per_s = nkf / warm_s
    extra = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "dtype": dtype,
        "mode": "lc",
        "keyframes": nkf,
        "cold_s": cold_s,
        "warm_s": warm_s,
        "warm_walls_s": walls,
        "num_loop_closures": res.stats["num_loop_closures"],
        "num_merged_tracks": res.stats["num_merged_tracks"],
        "ate_odometry_m": ate(res.base.trajectory, gt),
        "ate_final_m": ate(res.trajectory, gt),
        "refine_pick": res.stats["refine_pick"],
        "wall_breakdown": {k: res.stats[k] for k in LC_WALLS},
        "wall_confirm_stages": res.stats["wall_confirm_stages"],
    }
    if as_extra:
        print(json.dumps({"metric": "lc_keyframes_per_s",
                          "value": round(kf_per_s, 3), "unit": "kf/s",
                          "vs_baseline": round(kf_per_s / BASELINE_KF_PER_S,
                                               3), **extra}),
              file=sys.stderr)
    else:
        emit(kf_per_s, extra)
    return kf_per_s, extra


INTERACTIVE_FRAMES = 110
INTERACTIVE_WARMUP = 25


def interactive_config(dtype):
    """bench.py's interactive configuration (bench.py:474-479)."""
    from .config import SlamConfig
    return dataclasses.replace(
        SlamConfig(), compute_dtype=dtype, kf_rot_thr=1e-9, kf_tr_thr=1e-9,
        obs_buckets=(2048,), cam_buckets=(48,), line_buckets=(128,),
        corr_buckets=(128,))


def bench_interactive(device="cuda", dtype="float32", budget_s=480.0,
                      t_start=None, num_frames=INTERACTIVE_FRAMES,
                      warmup_frames=INTERACTIVE_WARMUP):
    """The per-frame engine on the house (bench.py:466-522): warm-up
    frames, then each measured frame timed on the host's clock (the frame
    reads its results from the card, so the time holds the device's work).
    Returns (kf/s, the stderr record); ``main`` prints them."""
    from . import resolve_device
    from .engine import Slam
    t_start = time.perf_counter() if t_start is None else t_start
    dev = resolve_device(device)
    cfg = interactive_config(dtype)
    frames, _ = workload(cfg, num_frames, 4)
    slam = Slam(cfg, device=dev)
    for i in range(warmup_frames):
        slam.process_frame(frames[i], i)
        if time.perf_counter() - t_start > 0.7 * budget_s:
            warmup_frames = i + 1
            break
    kf0 = len(slam.state.kfs)
    frame_times = []
    measured_end = warmup_frames
    for i in range(warmup_frames, num_frames):
        t0 = time.perf_counter()
        slam.process_frame(frames[i], i)
        frame_times.append(time.perf_counter() - t0)
        measured_end = i + 1
        if time.perf_counter() - t_start > 0.95 * budget_s:
            break
    nkf = len(slam.state.kfs) - kf0
    if nkf == 0 or not frame_times:
        raise RuntimeError("interactive bench: no keyframe measured")
    median_t = float(np.median(frame_times))
    kf_per_s = 1.0 / median_t
    stats = slam.post_processing()
    extra = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "dtype": dtype,
        "mode": "interactive",
        "mean_rate_kf_s": nkf / float(np.sum(frame_times)),
        "median_frame_ms": median_t * 1e3,
        "ba_mean_ms": stats["proc_local_ba_mean_s"] * 1e3,
        "vo_mean_ms": stats["proc_pose_estimation_mean_s"] * 1e3,
        "avg_ba_iterations": stats["avg_num_iterations"],
        "keyframes": nkf,
        "measured_frames": measured_end - warmup_frames,
        "frame_ms": [t * 1e3 for t in frame_times],
        "post_processing": stats,
    }
    return kf_per_s, extra


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    budget = float(os.environ.get("BENCH_BUDGET_S", 480))
    mode = os.environ.get("BENCH_MODE", "batch")
    if mode == "lc":
        bench_lc("cuda", budget_s=budget, t_start=t_start)
        return
    if mode == "interactive":
        emit(*bench_interactive("cuda", budget_s=budget, t_start=t_start))
        return
    bench_batch("cuda", budget_s=budget)
    # the lc measurement rides along as a stderr line (bench.py:555-566)
    remaining = budget - (time.perf_counter() - t_start)
    if os.environ.get("BENCH_LC", "1") != "0" and remaining > 200:
        try:
            bench_lc("cuda", budget_s=budget, t_start=t_start,
                     as_extra=True)
        except Exception as exc:
            print(json.dumps({"metric": "lc_keyframes_per_s",
                              "error": repr(exc)}), file=sys.stderr)


if __name__ == "__main__":
    main()
