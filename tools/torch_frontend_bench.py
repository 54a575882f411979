"""The image front-end on the port, end to end: rendered stereo frames ->
detector -> descriptor -> stereo/temporal matcher -> BatchSlam (every frame
a keyframe) -> the 2-round global refine -> ATE.

The port's counterpart of tools/frontend_bench.py (which measures the JAX
package): the same workload (the 74-segment house, the wave trajectory,
640x480 stereo, the renderer's stroke 1.5 and noise 2.0, render seed 0),
the same JSON keys, run on one CUDA device in float32.  The front-end fps
is frames over the wall of ``StereoLineMatcher.process`` as a user calls
it (the left and right images on the matcher's 2-thread pool).  A second
pass over the same images runs the same path (``StereoLineMatcher.side``
for each image, one after the other, then ``associate``) with a stage
runner that ends each stage by a device synchronize and times it, which
splits one frame's front-end wall into ``gradients`` (the maps on the
card), ``to_host`` (the one copy of magnitude and angle), ``grower``
(the native region grower), ``fuse_merge`` (the stroke-edge fusion and the
collinear merge), ``describe`` (the descriptors on the card and their copy
back), each summed over both images, and ``match`` (stereo pairing and
temporal association).  ``--profile`` adds the device's busy share over
the front-end loop (``torch.profiler``, as profile_replay.py measures it).

Usage:  python3 tools/torch_frontend_bench.py [--frames 60] [--stride 1]
            [--device cuda] [--profile]
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

STAGES = ("gradients", "to_host", "grower", "fuse_merge", "describe",
          "match")


def frontend_config():
    """tools/frontend_bench.py's configuration: ``SlamConfig()`` in float32
    with every frame a keyframe."""
    from slslam_tpu_torch.config import SlamConfig
    return dataclasses.replace(SlamConfig(), compute_dtype="float32",
                               kf_rot_thr=1e-9, kf_tr_thr=1e-9)


def render(cfg, num_frames, stride=1, seed=0):
    """(stereo images, ground-truth poses) of the house along the wave."""
    from slslam_tpu_torch.sim import (StereoImageRenderer, house_segments,
                                      wave_trajectory)
    poses = wave_trajectory(num_frames=400)[::stride][:num_frames]
    ren = StereoImageRenderer(house_segments(), cfg.camera, seed=seed)
    return [ren.render(T)[:2] for T in poses], poses


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def track(matcher, images):
    """Every frame through ``matcher.process``: (frames, wall seconds)."""
    frames = []
    _sync(matcher.detector.device)
    t0 = time.perf_counter()
    for i, (img_l, img_r) in enumerate(images):
        frames.append(matcher.process(i, img_l, img_r))
    _sync(matcher.detector.device)
    return frames, time.perf_counter() - t0


def stage_split(cfg, images, device):
    """Milliseconds per frame of each front-end stage (mean over frames):
    the path of ``StereoLineMatcher.process`` on a fresh matcher, one image
    after the other, each stage synchronized; the grower also per image."""
    from slslam_tpu_torch.frontend.matcher import StereoLineMatcher
    matcher = StereoLineMatcher(cfg.camera, device=device)
    totals = dict.fromkeys(STAGES, 0.0)

    def timed(stage, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        _sync(device)
        totals[stage] += time.perf_counter() - t0
        return out

    _sync(device)
    for i, pair in enumerate(images):
        sides = [matcher.side(img, timed) for img in pair]
        timed("match", matcher.associate, i, *sides)
    n = len(images)
    out = {k: 1e3 * v / n for k, v in totals.items()}
    out["grower_per_image"] = out["grower"] / 2
    out["total"] = sum(out[k] for k in STAGES)
    return out


def slam(cfg, frames, device):
    """BatchSlam over the tracked frames, then the 2-round refine: (result,
    refine result, wall seconds)."""
    from slslam_tpu_torch.engine.batch import BatchSlam, normalize_frames
    from slslam_tpu_torch.engine.refine import global_refine
    frames_n = normalize_frames(frames, cfg.camera)
    _sync(device)
    t0 = time.perf_counter()
    res = BatchSlam(cfg, device=device).run(frames_n)
    ref = global_refine(frames_n, res.is_kf, res.trajectory, config=cfg,
                        device=device)
    _sync(device)
    return res, ref, time.perf_counter() - t0


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def run(num_frames=60, stride=1, device="cuda", profile=False):
    """The bench's record (the JSON line's keys)."""
    import torch
    from slslam_tpu_torch import resolve_device
    from slslam_tpu_torch.bench import ate
    from slslam_tpu_torch.frontend.matcher import StereoLineMatcher
    dev = resolve_device(device)
    cfg = frontend_config()
    images, poses = render(cfg, num_frames, stride)
    # the first frame loads the card's modules: warm up on a throwaway
    # matcher outside the timed loop
    warm = StereoLineMatcher(cfg.camera, device=dev)
    warm.process(0, *images[0])
    warm.close()
    matcher = StereoLineMatcher(cfg.camera, device=dev)
    frames, wall = track(matcher, images)
    matcher.close()
    res, ref, t_slam = slam(cfg, frames, dev)
    kfi = np.flatnonzero(np.asarray(res.is_kf))
    gt = [poses[i] for i in kfi]
    out = {
        "platform": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "frames": len(frames),
        "frontend_fps": len(frames) / wall,
        "mean_tracks_per_frame": float(np.mean([len(f) for f in frames])),
        "keyframes": res.kf_count,
        "slam_wall_s": t_slam,
        "ate_raw_m": ate(res.trajectory, gt) if len(kfi) else None,
        "ate_refined_m": ate(ref.trajectory, gt) if len(kfi) else None,
        "refine_iterations": ref.iterations,
        "grower": matcher.detector.grower,
        "stage_ms": stage_split(cfg, images, dev),
    }
    if dev.type == "cuda":
        out["nvidia_smi"] = nvidia_smi()
    if profile:
        from profile_replay import device_profile

        def fresh_track():
            m = StereoLineMatcher(cfg.camera, device=dev)
            track(m, images)
            m.close()

        prof = device_profile(fresh_track, lambda: _sync(dev))
        out["device_busy_share"] = prof["device_busy_share"]
        out["profile"] = prof
    return out, frames, res, ref


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--stride", type=int, default=1,
                    help="temporal stride over the wave trajectory")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="also the device's busy share over the front-end "
                         "loop (torch.profiler)")
    args = ap.parse_args(argv)
    out = run(args.frames, args.stride, args.device, args.profile)[0]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
