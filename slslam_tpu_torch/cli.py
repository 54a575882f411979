"""Command-line driver of the PyTorch port.

    python -m slslam_tpu_torch.cli sim --frames 120 --noise-px 0.5 \\
        --out /tmp/run
    python -m slslam_tpu_torch.cli run --obs-dir data/it3f/line_tracking_result
    python -m slslam_tpu_torch.cli track --left-dir seq/left --right-dir \\
        seq/right [--vocab vocab.bin] --out /tmp/run

The ``sim``, ``run`` and ``track`` commands of ``slslam_tpu.cli`` with their
flags (the reference's --ba-window-size, --max-num-iter, --rseed, --robust,
--stopfrm; main.cpp:22-27).  ``sim`` renders the house world along the wave
trajectory (the port's copy of the simulation, render seed = --rseed);
``run`` replays the reference's line-track files (%04d.txt in pixel
coordinates) from --obs-dir; ``track`` runs the image front-end (detector,
descriptor, stereo/temporal matcher) over rectified stereo images
%04d.(png|jpg|jpeg|pgm|bmp) under --left-dir / --right-dir from --start,
and with --vocab the matcher's descriptors feed live place recognition (a
missing vocabulary file is trained from the sequence's first descriptors
and saved).  ``--engine interactive`` (the default, as in the JAX CLI)
drives the per-frame ``Slam``: it writes ``trajectory.txt``,
``landmarks.txt``, ``stats.json`` with ``post_processing()``'s keys and the
keyframes' frame ids (and ``sim``'s ``gt_trajectory.txt`` and ``ate_m``),
and with ``--checkpoint-every N`` a resumable ``checkpoint.npz`` every N
keyframes.  ``--engine batch`` replays through ``BatchSlam``; ``--refine``
then follows with the global bundle adjustment (``refine_*`` stats,
``refine_ate_m``, ``trajectory_refined.txt``) and is ignored, with a
warning, on the interactive engine.  ``--device`` defaults to ``cuda``;
``--device cpu`` runs the plain twins.  The JAX CLI's plots, viewers and
live views (``--live-dir``, ``--viz``, ``view``: P13) and its mesh flags
(P12) are not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def _config(args):
    from .config import SlamConfig
    return dataclasses.replace(
        SlamConfig(), ba_window_size=args.ba_window_size,
        max_num_iter=args.max_num_iter, rseed=args.rseed,
        robust=args.robust, compute_dtype=args.dtype)


def _write_stats(out, stats):
    with open(os.path.join(out, "stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
    for k, v in stats.items():
        print(f"  {k}: {v}")


def _gt_rows(poses_gt, kf_idx):
    from .evalio.writers import trajectory_rows
    T0 = poses_gt[kf_idx[0]]
    return trajectory_rows([(poses_gt[i] @ T0.inv()).inv() for i in kf_idx])


def _batch(args, cfg, frames, poses_gt=None, frame_ids=None):
    """The batch replay (and ``--refine``) of host frames."""
    import torch

    from .bench import ate
    from .engine.batch import BatchSlam
    from .engine.refine import global_refine
    from .evalio.writers import write_landmarks, write_trajectory

    eng = BatchSlam(cfg, device=args.device)
    t0 = time.perf_counter()
    res = eng.run(frames, frame_ids=frame_ids)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    wall = time.perf_counter() - t0

    kf_idx = np.flatnonzero(res.is_kf)
    stats = dict(res.stats)
    stats["wall_s"] = wall
    stats["kf_per_s"] = res.kf_count / max(wall, 1e-9)
    stats["device"] = str(eng.device)
    stats["dtype"] = str(eng.dtype)
    if res.kf_count and poses_gt is not None:
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
        if poses_gt is not None:
            stats["refine_ate_m"] = ate(ref.trajectory,
                                        [poses_gt[i] for i in kf_idx])
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        write_trajectory(os.path.join(args.out, "trajectory.txt"),
                         res.trajectory)
        write_landmarks(os.path.join(args.out, "landmarks.txt"),
                        res.world_segments(min_len=1.0))
        if ref is not None:
            write_trajectory(os.path.join(args.out,
                                          "trajectory_refined.txt"),
                             ref.trajectory)
        if res.kf_count and poses_gt is not None:
            np.savetxt(os.path.join(args.out, "gt_trajectory.txt"),
                       _gt_rows(poses_gt, kf_idx), delimiter="\t")
        _write_stats(args.out, stats)
    return stats


def _interactive(args, cfg, frames, poses_gt=None, normalized=True,
                 setup=None):
    """The per-frame engine over (frame_id, obs) pairs (slslam_tpu/cli.py
    cmd_sim / cmd_run / cmd_track / _finish); ``setup(slam)`` wires a
    place recognizer in before the first frame."""
    from .checkpoint import save_checkpoint
    from .engine import Slam
    from .evalio.traj import ate_position_error
    from .evalio.writers import trajectory_rows

    if args.refine:
        print("warning: --refine only applies to --engine batch; ignored "
              "on the interactive engine", file=sys.stderr)
    slam = Slam(cfg, device=args.device)
    if setup is not None:
        setup(slam)
    kf_frames = []
    t0 = time.perf_counter()
    n = 0
    for frame_id, obs in frames:
        if frame_id > args.stopfrm:
            break
        n += 1
        if slam.process_frame(obs, frame_id, normalized=normalized):
            kf_frames.append(frame_id)
            if (args.checkpoint_every and args.out
                    and len(kf_frames) % args.checkpoint_every == 0):
                os.makedirs(args.out, exist_ok=True)
                save_checkpoint(slam, os.path.join(args.out,
                                                   "checkpoint.npz"))
    wall = time.perf_counter() - t0
    print(f"processed {n} frames -> {len(kf_frames)} keyframes in "
          f"{wall:.2f}s ({len(kf_frames) / max(wall, 1e-9):.2f} kf/s) on "
          f"{slam.device}")

    stats = slam.post_processing()
    stats["device"] = str(slam.device)
    stats["dtype"] = str(slam.dtype)
    stats["keyframe_frames"] = kf_frames
    gt_rows = None
    if poses_gt is not None and kf_frames:
        gt_rows = _gt_rows(poses_gt, kf_frames)
        est = trajectory_rows(slam.trajectory())
        stats["ate_m"] = ate_position_error(est, gt_rows)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        slam.save_trajectory(os.path.join(args.out, "trajectory.txt"))
        slam.save_landmarks(os.path.join(args.out, "landmarks.txt"))
        if gt_rows is not None:
            np.savetxt(os.path.join(args.out, "gt_trajectory.txt"), gt_rows,
                       delimiter="\t")
        _write_stats(args.out, stats)
    return stats


def cmd_sim(args):
    from .sim import StereoLineRenderer, house_segments, wave_trajectory

    cfg = _config(args)
    poses_gt = wave_trajectory(num_frames=args.frames)
    poses_gt = poses_gt[:min(len(poses_gt), args.stopfrm + 1)]
    ren = StereoLineRenderer(house_segments(), cfg.camera,
                             noise_px=args.noise_px, seed=args.rseed)
    if args.engine == "batch":
        return _batch(args, cfg, [ren.observe(T) for T in poses_gt],
                      poses_gt)
    return _interactive(args, cfg, ((i, ren.observe(T))
                                    for i, T in enumerate(poses_gt)),
                        poses_gt)


def cmd_run(args):
    from .engine.batch import normalize_frames
    from .frontend.io import ObsFileLoader

    cfg = _config(args)
    loader = ObsFileLoader(args.obs_dir)
    if args.engine == "batch":
        pairs = []
        for frame_id, obs in loader:
            if frame_id > args.stopfrm:
                break
            pairs.append((frame_id, obs))
        frames = normalize_frames([o for _, o in pairs], cfg.camera)
        return _batch(args, cfg, frames, frame_ids=[i for i, _ in pairs])
    return _interactive(args, cfg, loader, normalized=False)


IMAGE_EXTS = ("png", "jpg", "jpeg", "pgm", "bmp")


def _stereo_frames(args):
    """(frame id, left path, right path) from --start while both images
    exist (slslam_tpu/cli.py:346-362)."""
    i = args.start
    while i <= args.stopfrm:
        hits = []
        for d in (args.left_dir, args.right_dir):
            found = None
            for ext in IMAGE_EXTS:
                p = os.path.join(d, f"{i:04d}.{ext}")
                if os.path.exists(p):
                    found = p
                    break
            hits.append(found)
        if None in hits:
            return
        yield i, hits[0], hits[1]
        i += 1


def _vocab_params(preset):
    from .loopclosure import VocTreeParams
    return {"indoor": VocTreeParams.indoor, "outdoor": VocTreeParams.outdoor,
            "outdoor-long": VocTreeParams.outdoor_long_loop}[preset]()


def _train_vocabulary(args, cfg, load):
    """A vocabulary from the sequence's own descriptors (slslam_tpu/cli.py:
    377-392): the tracks alive after each frame until the bank holds more
    than 200 descriptors, written to --vocab."""
    from .frontend.matcher import StereoLineMatcher
    from .loopclosure import VocTree, build_vocabulary
    print(f"training vocabulary -> {args.vocab}", file=sys.stderr)
    pre = StereoLineMatcher(cfg.camera, device=args.device)
    bank = []
    for frame_id, pl_, pr_ in _stereo_frames(args):
        if len(bank) > 200:
            break
        pre.process(frame_id, *load(pl_, pr_))
        bank.extend(t.desc for t in pre.tracks.values())
    pre.close()
    vocab = build_vocabulary(np.asarray(bank, np.float32))
    VocTree(vocab, _vocab_params(args.vocab_preset),
            device=args.device).save(args.vocab)


def cmd_track(args):
    """The image front-end into the engine (slslam_tpu/cli.py:337-423):
    detector -> descriptors -> stereo/temporal matcher -> ``Slam``, with
    live place recognition over the matcher's descriptors when --vocab is
    given."""
    from PIL import Image

    from .frontend.matcher import StereoLineMatcher

    if args.live_dir:
        raise SystemExit("--live-dir needs the tracking views of viz.py, "
                         "which the port does not have yet (P13)")
    cfg = _config(args)
    matcher = StereoLineMatcher(cfg.camera, device=args.device)

    def load(pl_, pr_):
        return tuple(np.asarray(Image.open(p).convert("L"), np.float32)
                     for p in (pl_, pr_))

    def frames():
        for frame_id, pl_, pr_ in _stereo_frames(args):
            yield frame_id, matcher.process(frame_id, *load(pl_, pr_))

    if args.engine == "batch":
        print("warning: track runs the interactive engine, as the JAX CLI's "
              "does; --engine batch ignored", file=sys.stderr)
    try:
        slam_setup = None
        if args.vocab:
            from .loopclosure import PlaceRecognizer, VocTree
            if not os.path.exists(args.vocab):
                _train_vocabulary(args, cfg, load)
            tree = VocTree.load(args.vocab, _vocab_params(args.vocab_preset),
                                device=args.device)

            def slam_setup(slam):
                slam.place_recognizer = PlaceRecognizer(tree)
                slam.descriptor_source = matcher.descriptors
        return _interactive(args, cfg, frames(), normalized=False,
                            setup=slam_setup)
    finally:
        matcher.close()


def _add_common(p):
    p.add_argument("--engine", choices=("interactive", "batch"),
                   default="interactive",
                   help="interactive = the per-frame engine (loop closure, "
                        "checkpoints); batch = the whole replay on the card")
    p.add_argument("--ba-window-size", type=int, default=10)
    p.add_argument("--max-num-iter", type=int, default=10)
    p.add_argument("--rseed", type=int, default=4,
                   help="seed of the renderer and of the random streams")
    p.add_argument("--robust", action="store_true", default=True)
    p.add_argument("--no-robust", dest="robust", action="store_false")
    p.add_argument("--stopfrm", type=int, default=99999)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the twins)")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--refine", action="store_true",
                   help="batch engine: follow the replay with one global "
                        "bundle adjustment over every keyframe")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="interactive engine: save a resumable checkpoint "
                        "into --out every N keyframes (0 = off)")
    p.add_argument("--out", default=None, help="output directory")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="slslam_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("sim", help="run on the simulated house world")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--noise-px", type=float, default=0.5)
    _add_common(p)
    p.set_defaults(fn=cmd_sim)
    p = sub.add_parser("run", help="replay line-track files from disk")
    p.add_argument("--obs-dir", required=True)
    _add_common(p)
    p.set_defaults(fn=cmd_run)
    p = sub.add_parser("track", help="the image front-end on rectified "
                       "stereo images, into the engine")
    p.add_argument("--left-dir", required=True)
    p.add_argument("--right-dir", required=True)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--vocab", default=None,
                   help="voctree vocabulary file: live place recognition "
                        "and loop closure; trained from the sequence if the "
                        "file does not exist")
    p.add_argument("--vocab-preset",
                   choices=("indoor", "outdoor", "outdoor-long"),
                   default="indoor",
                   help="voctree parameter preset (voctree_bf.h:24-43)")
    p.add_argument("--live-dir", default=None,
                   help="not ported: the tracking views need viz.py (P13)")
    _add_common(p)
    p.set_defaults(fn=cmd_track)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
