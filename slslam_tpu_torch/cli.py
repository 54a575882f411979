"""Command-line driver of the PyTorch port.

    python -m slslam_tpu_torch.cli sim --frames 120 --noise-px 0.5 \\
        --out /tmp/run
    python -m slslam_tpu_torch.cli run --obs-dir data/it3f/line_tracking_result
    python -m slslam_tpu_torch.cli track --left-dir seq/left --right-dir \\
        seq/right [--vocab vocab.bin] --out /tmp/run
    python -m slslam_tpu_torch.cli gen --frames 400 --out /tmp/house_seq
    python -m slslam_tpu_torch.cli view --run /tmp/run

The commands of ``slslam_tpu.cli`` with their
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
warning, on the interactive engine.  ``--plot`` writes a top-down
``map.png`` and ``--viz`` a self-contained 3D viewer ``map.html`` into
--out (``viz.py``, ``viz_interactive.py``); ``--live-dir`` writes the
interactive engine's stereo tracking view ``tracking_%05d.png`` every
``--live-every`` frames; ``--profile-dir`` records the command under
``torch.profiler`` (CPU activity, and CUDA activity on the card) and
writes a Chrome trace there; ``sim --verbose`` prints the engine's
progress to stderr.  ``gen`` writes a rendered house sequence (line-track
files and ``gt_trajectory.txt``) that ``run --obs-dir`` reads, and
``view`` builds ``map.html`` from a finished run directory.  ``--device``
defaults to ``cuda``; ``--device cpu`` runs the plain twins.

``--mesh-devices N`` runs the interactive engine's window BA line-sharded
and its PGO edge-sharded over N ranks (``parallel/``), one process each,
started by torchrun (``torchrun --nproc-per-node N -m slslam_tpu_torch.cli
sim ... --mesh-devices N``) or by ``--multihost --coordinator HOST:PORT
--num-processes N --process-id I`` in each; every rank runs on
``cuda:{local rank % card count}`` (or the CPU with ``--device cpu``), the
group on NCCL when each rank has a card of its own and on gloo otherwise
(``parallel/multihost.py``).  Only the primary rank (rank 0) writes
outputs, tracking views, checkpoints, plots, traces and a trained
vocabulary.
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
        robust=args.robust, compute_dtype=args.dtype,
        mesh_devices=args.mesh_devices)


def _write_stats(out, stats):
    with open(os.path.join(out, "stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
    for k, v in stats.items():
        print(f"  {k}: {v}")


def _gt_rows(poses_gt, kf_idx):
    from .evalio.writers import trajectory_rows
    T0 = poses_gt[kf_idx[0]]
    return trajectory_rows([(poses_gt[i] @ T0.inv()).inv() for i in kf_idx])


def _write_maps(args, trajectory, segments, gt_rows, viz_trajectory=None):
    """--plot's ``map.png`` and --viz's ``map.html`` in --out
    (slslam_tpu/cli.py:120-130, 203-214)."""
    if args.plot:
        from .viz import plot_map
        plot_map(trajectory, segments, os.path.join(args.out, "map.png"),
                 gt_trajectory=gt_rows)
    if args.viz:
        from .viz_interactive import export_interactive_map
        export_interactive_map(os.path.join(args.out, "map.html"),
                               viz_trajectory or trajectory, segments,
                               gt_rows=gt_rows)


def _primary():
    from .parallel.multihost import is_primary
    return is_primary()


def _live_due(args, frame_id):
    return (args.live_dir is not None and frame_id % args.live_every == 0
            and _primary())


def _live_view(args, cfg, frame_id, obs, images=(None, None)):
    """The stereo tracking view of one frame, ``tracking_%05d.png`` in
    --live-dir (slslam_tpu/cli.py:268-276, 411-420): pixel observations
    over the images, or over a blank canvas of the camera's size."""
    from .viz import plot_observations
    plot_observations(*images, obs, os.path.join(
        args.live_dir, f"tracking_{frame_id:05d}.png"),
        image_size=(cfg.camera.image_width, cfg.camera.image_height),
        title=f"frame {frame_id}")


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
    if args.out and _primary():
        os.makedirs(args.out, exist_ok=True)
        write_trajectory(os.path.join(args.out, "trajectory.txt"),
                         res.trajectory)
        write_landmarks(os.path.join(args.out, "landmarks.txt"),
                        res.world_segments(min_len=1.0))
        if ref is not None:
            write_trajectory(os.path.join(args.out,
                                          "trajectory_refined.txt"),
                             ref.trajectory)
        gt_rows = None
        if res.kf_count and poses_gt is not None:
            gt_rows = _gt_rows(poses_gt, kf_idx)
            np.savetxt(os.path.join(args.out, "gt_trajectory.txt"),
                       gt_rows, delimiter="\t")
        _write_stats(args.out, stats)
        _write_maps(args, res.trajectory, res.world_segments(min_len=0.5),
                    gt_rows, ref.trajectory if ref is not None else None)
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
    verbose = getattr(args, "verbose", False)      # sim's flag
    slam = Slam(cfg, device=args.device)
    slam.verbose = verbose
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
            if (args.checkpoint_every and args.out and _primary()
                    and len(kf_frames) % args.checkpoint_every == 0):
                os.makedirs(args.out, exist_ok=True)
                save_checkpoint(slam, os.path.join(args.out,
                                                   "checkpoint.npz"))
        if verbose and frame_id % 20 == 0:
            print(f"frame {frame_id}: kfs={len(kf_frames)} "
                  f"lms={len(slam.state.lms)}", file=sys.stderr)
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
    if args.out and _primary():
        os.makedirs(args.out, exist_ok=True)
        slam.save_trajectory(os.path.join(args.out, "trajectory.txt"))
        slam.save_landmarks(os.path.join(args.out, "landmarks.txt"))
        if gt_rows is not None:
            np.savetxt(os.path.join(args.out, "gt_trajectory.txt"), gt_rows,
                       delimiter="\t")
        _write_stats(args.out, stats)
        _write_maps(args, slam.trajectory(),
                    slam._landmark_world_segments(min_len=0.5), gt_rows)
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

    def frames():
        for i, T in enumerate(poses_gt):
            if _live_due(args, i):
                _live_view(args, cfg, i, ren.observe_pixels(T))
            yield i, ren.observe(T)

    return _interactive(args, cfg, frames(), poses_gt)


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

    def frames():
        for frame_id, obs in loader:
            if frame_id > args.stopfrm:
                return
            if _live_due(args, frame_id):
                _live_view(args, cfg, frame_id, obs)
            yield frame_id, obs

    return _interactive(args, cfg, frames(), normalized=False)


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
    than 200 descriptors, written to --vocab by the primary rank; returns
    the tree (every rank trains the same one)."""
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
    tree = VocTree(vocab, _vocab_params(args.vocab_preset),
                   device=args.device)
    if _primary():
        tree.save(args.vocab)
    return tree


def cmd_track(args):
    """The image front-end into the engine (slslam_tpu/cli.py:337-423):
    detector -> descriptors -> stereo/temporal matcher -> ``Slam``, with
    live place recognition over the matcher's descriptors when --vocab is
    given."""
    from PIL import Image

    from .frontend.matcher import StereoLineMatcher

    cfg = _config(args)
    matcher = StereoLineMatcher(cfg.camera, device=args.device)

    def load(pl_, pr_):
        return tuple(np.asarray(Image.open(p).convert("L"), np.float32)
                     for p in (pl_, pr_))

    def frames():
        for frame_id, pl_, pr_ in _stereo_frames(args):
            images = load(pl_, pr_)
            obs = matcher.process(frame_id, *images)
            if _live_due(args, frame_id):
                _live_view(args, cfg, frame_id, obs, images)
            yield frame_id, obs

    if args.engine == "batch":
        print("warning: track runs the interactive engine, as the JAX CLI's "
              "does; --engine batch ignored", file=sys.stderr)
    try:
        slam_setup = None
        if args.vocab:
            from .loopclosure import PlaceRecognizer, VocTree
            if os.path.exists(args.vocab):
                tree = VocTree.load(args.vocab,
                                    _vocab_params(args.vocab_preset),
                                    device=args.device)
            else:
                tree = _train_vocabulary(args, cfg, load)

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
    p.add_argument("--plot", action="store_true",
                   help="write a top-down map.png into --out")
    p.add_argument("--viz", action="store_true",
                   help="write map.html into --out: a self-contained "
                        "interactive 3D viewer (orbit/pan/zoom, top-down, "
                        "keyframe playback)")
    p.add_argument("--live-dir", default=None,
                   help="interactive engine: write stereo tracking views "
                        "(tracking_%%05d.png) here")
    p.add_argument("--live-every", type=int, default=10,
                   help="tracking-view cadence in frames (with --live-dir)")
    p.add_argument("--profile-dir", default=None,
                   help="record the command with torch.profiler and write "
                        "a Chrome trace (trace.json) here")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="interactive engine: run the window BA and the PGO "
                        "sharded over this many ranks (the process group's "
                        "world size)")
    p.add_argument("--multihost", action="store_true",
                   help="join a process group before running: with "
                        "--coordinator/--num-processes/--process-id, or "
                        "from torchrun's environment")
    p.add_argument("--coordinator", default=None,
                   help="HOST:PORT of rank 0 (with --multihost)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def cmd_view(args):
    """``map.html`` from a finished run directory (trajectory.txt,
    landmarks.txt and, where present, gt_trajectory.txt;
    slslam_tpu/cli.py:426-453)."""
    from .hostgeom import Pose, rodrigues
    from .viz_interactive import export_interactive_map

    run = args.run
    rows = np.atleast_2d(np.loadtxt(os.path.join(run, args.trajectory)))
    traj = [Pose(rodrigues(np.asarray(r[4:7], float)),
                 np.array([-r[2], -r[3], r[1]])) for r in rows]
    segs = np.zeros((0, 6))
    lm_path = os.path.join(run, "landmarks.txt")
    if os.path.exists(lm_path):
        lm = np.atleast_2d(np.loadtxt(lm_path))
        if lm.size:
            # landmark rows are (z1 -y1 x1 z2 -y2 x2) (evalio/writers.py)
            segs = np.stack([lm[:, 2], -lm[:, 1], lm[:, 0],
                             lm[:, 5], -lm[:, 4], lm[:, 3]], axis=1)
    gt = None
    gt_path = os.path.join(run, "gt_trajectory.txt")
    if os.path.exists(gt_path):
        gt = np.atleast_2d(np.loadtxt(gt_path))
    out = args.out or os.path.join(run, "map.html")
    export_interactive_map(out, traj, segs, gt_rows=gt,
                           title=os.path.basename(os.path.abspath(run)))
    print(f"wrote {out}")
    return out


def cmd_gen(args):
    """A rendered house sequence on disk (slslam_tpu/cli.py:456-471): the
    renderer's line-track files %04d.txt and gt_trajectory.txt."""
    from .config import CameraConfig
    from .evalio.writers import trajectory_rows
    from .sim import StereoLineRenderer, house_segments, wave_trajectory

    poses = wave_trajectory(num_frames=args.frames)
    ren = StereoLineRenderer(house_segments(), CameraConfig(),
                             noise_px=args.noise_px, seed=args.rseed)
    out = args.out or "house_seq"
    ren.write_sequence(out, poses)
    gt_rows = trajectory_rows([(T @ poses[0].inv()).inv() for T in poses])
    np.savetxt(os.path.join(out, "gt_trajectory.txt"), gt_rows,
               delimiter="\t")
    print(f"wrote {args.frames} frames to {out}")
    return out


def _profiled(args):
    """``args.fn(args)`` under torch.profiler (CPU activity, and CUDA
    activity on the card), its Chrome trace written to
    ``<--profile-dir>/trace.json`` (the JAX CLI's jax.profiler trace,
    slslam_tpu/cli.py:85-86, 132-134)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = args.fn(args)
        if cuda:
            torch.cuda.synchronize()
    if not _primary():
        return out
    os.makedirs(args.profile_dir, exist_ok=True)
    path = os.path.join(args.profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"wrote the profile trace {path}", file=sys.stderr)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="slslam_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("sim", help="run on the simulated house world")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--noise-px", type=float, default=0.5)
    p.add_argument("--verbose", action="store_true",
                   help="interactive engine: print progress every 20 frames")
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
    _add_common(p)
    p.set_defaults(fn=cmd_track)
    p = sub.add_parser("view", help="build the interactive HTML map viewer "
                       "from a run directory")
    p.add_argument("--run", required=True, help="run output directory")
    p.add_argument("--trajectory", default="trajectory.txt",
                   help="trajectory file within --run (e.g. "
                        "trajectory_refined.txt)")
    p.add_argument("--out", default=None,
                   help="output html path (default <run>/map.html)")
    p.set_defaults(fn=cmd_view)
    p = sub.add_parser("gen", help="write a rendered house sequence to disk")
    p.add_argument("--frames", type=int, default=400)
    p.add_argument("--noise-px", type=float, default=0.5)
    p.add_argument("--rseed", type=int, default=4)
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_gen)
    args = ap.parse_args(argv)
    started = _join_group(args)
    try:
        if getattr(args, "profile_dir", None):
            return _profiled(args)
        return args.fn(args)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _join_group(args):
    """With --multihost, or under torchrun (its WORLD_SIZE and RANK set)
    with --mesh-devices > 1, start this rank's process group and move
    --device to the rank's own (slslam_tpu/cli.py:76-82).  Returns whether
    it started one."""
    torchrun = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if not (getattr(args, "multihost", False)
            or (getattr(args, "mesh_devices", 0) > 1 and torchrun)):
        return False
    from .parallel.multihost import initialize_multihost
    info = initialize_multihost(args.coordinator, args.num_processes,
                                args.process_id, device=args.device)
    args.device = info["device"]
    print(f"multihost: {info}", file=sys.stderr)
    return True


if __name__ == "__main__":
    main()
