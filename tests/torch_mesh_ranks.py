"""Rank bodies of the port's distributed tests (imports no jax).

``parallel.run_local_ranks`` spawns each rank in a fresh interpreter that
imports the function it runs by module path; these functions live here, in
a module that imports only the port, so the ranks never load jax.  Each
takes (rank, world, device, ...) and returns numpy results.
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from slslam_tpu_torch.parallel import (all_gather_shards, comm_counts,
                                       dist_local_ba_lines,
                                       dist_pose_graph_opt, partition_by_line,
                                       reset_comm_counts)


def _t(a, dev, dtype=torch.float64):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return torch.as_tensor(a, dtype=dtype, device=dev)
    return torch.as_tensor(a, device=dev)


def ba_rank(rank, world, dev, problem, baseline, huber_delta,
            max_iters=10, dtype=torch.float64):
    """One sharded window solve of ``problem`` (cam0, orth0, obs, obs_cam,
    obs_line, obs_valid, cam_free, line_free; numpy): (cameras, lines in
    global order, LM iterations, initial and final cost, comm counts of
    the solve without the gather, the group's backend)."""
    cam0, orth0, obs, oc, ol, ov, cf, lf = problem
    lo, lfs, ob, ocs, ols, ovs, perm = partition_by_line(
        orth0, lf, obs, oc, ol, ov, world)
    reset_comm_counts()
    cam, line, stats = dist_local_ba_lines(
        None, _t(cam0, dev, dtype), _t(lo[rank], dev, dtype),
        _t(ob[rank], dev, dtype), _t(ocs[rank], dev), _t(ols[rank], dev),
        _t(ovs[rank], dev), _t(cf, dev), _t(lfs[rank], dev), baseline,
        huber_delta, max_iters=max_iters)
    counts = comm_counts()
    lines = all_gather_shards(None, line).reshape(-1, 4)[perm]
    return (cam.cpu().numpy(), lines.cpu().numpy(), int(stats.iterations),
            float(stats.initial_cost), float(stats.final_cost), counts,
            dist.get_backend())


def house_window_problem(num_cams=4, noise_px=0.3, pad_obs=1024, seed=1):
    """tests/test_distributed.py's ``padded_ba_problem`` (and test_ba.py's
    ``make_problem``) with the port's simulation and hostgeom, in numpy:
    house cameras 6 frames apart, the lines seen twice, perturbed starts,
    camera 0 fixed, observations padded to ``pad_obs``."""
    from slslam_tpu_torch.config import CameraConfig
    from slslam_tpu_torch.hostgeom import av_to_orth_np
    from slslam_tpu_torch.sim import (StereoLineRenderer, house_segments,
                                      wave_trajectory)
    segs = house_segments()
    poses = wave_trajectory(num_frames=60)[::6][:num_cams]
    ren = StereoLineRenderer(segs, CameraConfig(), noise_px=noise_px,
                             seed=seed)
    frames = [ren.observe(T) for T in poses]
    seen = {}
    for f in frames:
        for sid in f:
            seen[sid] = seen.get(sid, 0) + 1
    lm_ids = sorted(sid for sid, c in seen.items() if c >= 2)
    av = []
    for sid in lm_ids:
        p1, p2 = segs[sid][:3], segs[sid][3:]
        v = p2 - p1
        av.append(np.concatenate([np.cross(v, np.cross(p1, p2)) / (v @ v),
                                  v]))
    rows = [(f[sid], ci, li) for ci, f in enumerate(frames)
            for li, sid in enumerate(lm_ids) if sid in f]
    O, C, L = len(rows), num_cams, len(lm_ids)
    rng = np.random.default_rng(42)
    cam0 = np.stack([T.wt() for T in poses])
    cam0[1:] += rng.standard_normal((C - 1, 6)) * 0.02
    orth0 = av_to_orth_np(np.stack(av)) + rng.standard_normal((L, 4)) * 0.005
    obs = np.zeros((pad_obs, 8))
    oc = np.zeros(pad_obs, np.int32)
    ol = np.zeros(pad_obs, np.int32)
    valid = np.zeros(pad_obs, bool)
    obs[:O] = np.stack([r[0] for r in rows])
    oc[:O] = [r[1] for r in rows]
    ol[:O] = [r[2] for r in rows]
    valid[:O] = True
    cam_free = np.ones(C, bool)
    cam_free[0] = False
    return cam0, orth0, obs, oc, ol, valid, cam_free, np.ones(L, bool)


def pgo_rank(rank, world, dev, args, max_iters=10):
    """``dist_pose_graph_opt`` of the whole padded graph ``args`` (poses,
    ei, ej, ctr, e_valid, pose_free; numpy): (poses, iterations)."""
    poses, ei, ej, ctr, ev, free = (_t(a, dev) for a in args)
    out, stats = dist_pose_graph_opt(None, poses, ei, ej, ctr, ev, free,
                                     max_iters=max_iters)
    return out.cpu().numpy(), int(stats.iterations)


class ReplayGumbel:
    """A ``gumbel_hook`` that hands out recorded noise, call by call."""

    def __init__(self, noises):
        self.noises = noises

    def __call__(self, i, H, Nb):
        g = self.noises[i]
        assert g.shape == (H, Nb), (g.shape, H, Nb)
        return torch.as_tensor(g)


def slam_rank(rank, world, dev, cfg, frames, noises):
    """The port's ``Slam`` with ``mesh_devices=world`` over ``frames``, fed
    the recorded RANSAC ``noises``, then one ``pose_optimization`` of its
    graph: (keyframe frames, trajectory rows, edge set, landmark ids,
    window LM iterations, post_processing, trajectory rows after the
    PGO)."""
    from slslam_tpu_torch.engine import Slam
    slam = Slam(dataclasses.replace(cfg, mesh_devices=world), device=dev,
                gumbel_hook=ReplayGumbel(noises))
    return run_slam(slam, frames)


def run_slam(slam, frames):
    """``slam_rank``'s run and results, for any engine."""
    from slslam_tpu_torch.evalio.writers import trajectory_rows
    kf = [i for i, f in enumerate(frames) if slam.process_frame(f, i)]
    rows = np.asarray(trajectory_rows(slam.trajectory()))
    slam.pose_optimization()
    return (kf, rows, sorted(slam.state.edge_set), sorted(slam.state.lms),
            slam.sum_num_iteration, slam.post_processing(),
            np.asarray(trajectory_rows(slam.trajectory())))


def failing_rank(rank, world, dev):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def hung_rank(rank, world, dev):
    """Rank 0 waits in an all-reduce that rank 1 never joins."""
    import time

    from slslam_tpu_torch.parallel import all_reduce_sum
    if rank == 1:
        time.sleep(3600)
    return all_reduce_sum(None, torch.zeros(1))[0].item()


def dying_rank(rank, world, dev):
    """Rank 1's process ends at once, as a crash would end it."""
    import os
    import time
    if rank == 1:
        os._exit(3)
    time.sleep(3600)
