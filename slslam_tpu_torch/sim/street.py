"""Real-sequence proxy worlds (a copy of ``slslam_tpu/sim/street.py``):
replay the reference's committed keyframe trajectories through a
synthesized matched-scale line world.

The reference's it(bt)3f / olympic4f / myungdong datasets were never
released; only the resulting keyframe trajectories are
(matlab_script/traj_slslam_*_basize10_*.txt, written by the reference's
src/slam.cpp:1489-1494 as ``i t_z -t_x -t_y w0 w1 w2`` of the
camera-to-world pose).  This module rebuilds each sequence's motion from
those files (keyframe spacing, rotation rates, path length and loop
structure as recorded) and surrounds the path with corridor or street
scenery at the sequence's scale: vertical building and door edges and
horizontal facade lines on both sides, near-field signs and overhead
banners where the street has them.  With the renderer's visibility model
this gives the real workloads' statistics (track churn, track lengths,
optionally association outliers) against exact ground truth.

The trajectory files are read from ``REFERENCE_DIR`` (``reference/
matlab_script`` in the repository) unless a caller names another
directory.  ``tests/test_torch_copies.py`` holds the helpers that read no
file (``interpolate_poses``, ``corridor_segments``, ``OutlierInjector``)
to the originals.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..hostgeom import Pose, rodrigues


REFERENCE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "reference", "matlab_script")


def load_reference_poses(path: str) -> List[Pose]:
    """Load a reference trajectory file as world->camera poses.

    Rows are ``i t_z -t_x -t_y w0 w1 w2`` of the camera-to-world pose
    (src/slam.cpp:1489-1494); the returned poses invert that, matching the
    sim convention (p_cam = R p_world + t) the renderer consumes.
    """
    rows = np.loadtxt(path)
    poses = []
    for r in rows:
        t_c2w = np.array([-r[2], -r[3], r[1]])
        R_c2w = rodrigues(np.asarray(r[4:7], float))
        poses.append(Pose(R_c2w, t_c2w).inv())
    return poses


def interpolate_poses(poses_wc: List[Pose], max_rot: float = 0.05,
                      max_trans: float = 0.25) -> List[Pose]:
    """Subdivide keyframe-to-keyframe steps into video-rate motion.

    The committed trajectories hold only KEYFRAMES (15 deg / 0.75 m gates,
    slam.cpp:1374-1382); the real system tracked every video frame in
    between.  Replaying raw keyframes asks VO to swallow 15-degree jumps
    the real front-end never saw — so subdivide each step until rotation
    <= max_rot rad and camera-center motion <= max_trans m.  Rotation
    interpolates along the geodesic; the camera center linearly.  (The
    interpolant need not match the unknown true inter-keyframe path — the
    world is rendered and evaluated from the same poses.)
    """
    from ..hostgeom import so3_log
    out: List[Pose] = []
    for k in range(len(poses_wc) - 1):
        T0, T1 = poses_wc[k], poses_wc[k + 1]
        w_rel = so3_log(T1.R @ T0.R.T)
        c0, c1 = T0.inv().t, T1.inv().t
        n = max(1, int(np.ceil(np.linalg.norm(w_rel) / max_rot)),
                int(np.ceil(np.linalg.norm(c1 - c0) / max_trans)))
        for j in range(n):
            s = j / n
            R = rodrigues(s * w_rel) @ T0.R
            c = (1.0 - s) * c0 + s * c1
            out.append(Pose(R, -R @ c))
    out.append(poses_wc[-1])
    return out


def _path_stations(positions: np.ndarray, gap: float,
                   return_arcs: bool = False):
    """Resample a polyline at ~gap arc-length spacing; returns (P, tangents)
    (+ per-station arc length when return_arcs)."""
    seg = np.diff(positions, axis=0)
    seglen = np.linalg.norm(seg, axis=1)
    s = np.concatenate([[0.0], np.cumsum(seglen)])
    total = s[-1]
    n = max(2, int(total / gap) + 1)
    si = np.linspace(0.0, total, n)
    pts = np.stack([np.interp(si, s, positions[:, k]) for k in range(3)],
                   axis=1)
    tan = np.gradient(pts, axis=0)
    nrm = np.linalg.norm(tan, axis=1, keepdims=True)
    tan = tan / np.maximum(nrm, 1e-9)
    if return_arcs:
        return pts, tan, si
    return pts, tan


def corridor_segments(poses_wc: List[Pose], lateral: float = 4.0,
                      station_gap: float = 1.5, height: float = 3.0,
                      up=(0.0, -1.0, 0.0), n_heights: int = 2,
                      jitter: float = 0.3, seed: int = 0,
                      sign_density: float = 0.0,
                      banner_every: int = 0,
                      return_arcs: bool = False) -> np.ndarray:
    """Line-segment world flanking a camera path (both sides).

    At stations every ``station_gap`` meters along the path, place on each
    side at distance ``lateral``: one vertical edge (floor to ``height``)
    and, between consecutive stations, ``n_heights`` horizontal facade
    lines — the door-frame / wall-corner / window-sill structure indoor and
    street sequences actually contain.  ``up`` is the world up direction
    (the reference's saved frame has camera-y pointing down, so up=-y).
    Returns (N, 6) world segments (x1 y1 z1 x2 y2 z2).

    Near-field structure (r3): a wall-only world leaves the camera with
    nothing closer than ``lateral/tan(fov/2)`` ~ 9-17 m when it looks
    straight down the street, which makes yaw vs lateral-translation a
    near-null Fisher pair — measured on the myungdong proxy, VO confused
    a pure forward step for 0.7 m of crab + 0.04 rad of yaw through an
    entire straight section.  Real market streets resolve this with
    close clutter, so:
    * ``sign_density`` > 0 adds protruding sign/stall edges per station
      — short segments at 25-60% of ``lateral`` (myungdong's shopfront
      signs; olympic4f's concourse columns);
    * ``banner_every`` > 0 hangs an overhead line ACROSS the path every
      that many stations (myungdong's street banners) — perpendicular,
      near, and high-parallax: the single strongest yaw/lateral anchor.
    """
    rng = np.random.default_rng(seed)
    up = np.asarray(up, float)
    up = up / np.linalg.norm(up)
    centers = np.stack([T.inv().t for T in poses_wc])   # camera positions
    pts, tan, si = _path_stations(centers, station_gap, return_arcs=True)
    # project tangents off the up axis so lateral is horizontal
    tan = tan - (tan @ up)[:, None] * up[None, :]
    tan /= np.maximum(np.linalg.norm(tan, axis=1, keepdims=True), 1e-9)
    lat = np.cross(up[None, :], tan)
    lat /= np.maximum(np.linalg.norm(lat, axis=1, keepdims=True), 1e-9)

    # floor height: a bit below the camera path
    floor = pts - 1.2 * up[None, :]

    segs = []
    arcs = []
    for side in (-1.0, 1.0):
        base = floor + side * lateral * lat \
            + rng.normal(0.0, jitter, floor.shape) * 0.5
        # vertical edges at every station
        for k in range(len(pts)):
            h = height * rng.uniform(0.7, 1.3)
            segs.append(np.concatenate([base[k], base[k] + h * up]))
            arcs.append(si[k])
        # horizontal facade lines between consecutive stations — kept away
        # from camera height (the path runs ~1.2 above the floor): a wall
        # line at exactly camera height is coplanar with the stereo
        # baseline, the known triangulation degeneracy (verify SKILL.md;
        # both back-projected planes coincide)
        for k in range(len(pts) - 1):
            for j in range(n_heights):
                h = (0.45 if j == 0 else 2.2) + rng.uniform(-0.2, 0.2)
                a = base[k] + h * up
                b = base[k + 1] + h * up
                segs.append(np.concatenate([a, b]))
                arcs.append(0.5 * (si[k] + si[k + 1]))
        # oblique edges (door frames, braces, shopfront diagonals): a
        # vertical component keeps them off the epipolar plane everywhere
        for k in range(len(pts) - 1):
            h1 = height * rng.uniform(0.05, 0.45)
            h2 = height * rng.uniform(0.55, 0.95)
            a = base[k] + h1 * up
            b = base[k + 1] + h2 * up
            segs.append(np.concatenate([a, b]))
            arcs.append(0.5 * (si[k] + si[k + 1]))
        # protruding signs / stalls: short near-field edges
        if sign_density > 0:
            for k in range(len(pts)):
                for _ in range(int(sign_density + rng.random())):
                    r = rng.uniform(0.25, 0.6) * lateral
                    p0 = floor[k] + side * r * lat[k] \
                        + rng.uniform(0.3, 0.8) * station_gap * tan[k]
                    h0 = rng.uniform(1.8, 2.6)
                    # sign board: one vertical drop + one short edge
                    a = p0 + h0 * up
                    segs.append(np.concatenate([a, a + rng.uniform(0.4, 0.9)
                                                * up]))
                    arcs.append(si[k])
                    d = (tan[k] if rng.random() < 0.5 else
                         side * lat[k]) * rng.uniform(0.4, 1.0)
                    segs.append(np.concatenate([a, a + d + 0.12 * up]))
                    arcs.append(si[k])
    if banner_every and banner_every > 0:
        for k in range(0, len(pts) - 1, banner_every):
            h = rng.uniform(3.0, 3.8)
            sag = rng.uniform(0.0, 0.25)
            a = floor[k] + lateral * lat[k] + h * up
            b = floor[k] - lateral * lat[k] + (h - sag) * up
            segs.append(np.concatenate([a, b]))
            arcs.append(si[k])
    if return_arcs:
        return np.asarray(segs), np.asarray(arcs)
    return np.asarray(segs)


class OutlierInjector:
    """Swap a fraction of per-frame track ids — association outliers.

    A real matcher's failure mode is the wrong correspondence, not noise:
    two similar lines swap identities.  Swapping ids (rather than
    corrupting coordinates) keeps every observation geometrically valid
    for SOME line while being an outlier for the track it is filed under —
    exactly what VO RANSAC (slam.cpp:640-689 role) and the Huber loss in
    BA must reject.
    """

    def __init__(self, frac: float = 0.05, seed: int = 0):
        self.frac = frac
        self.rng = np.random.default_rng(seed)

    def __call__(self, obs: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
        ids = list(obs.keys())
        n_swap = int(len(ids) * self.frac / 2.0 + self.rng.random())
        if n_swap == 0 or len(ids) < 4:
            return obs
        out = dict(obs)
        pick = self.rng.choice(len(ids), size=min(2 * n_swap, len(ids) // 2 * 2),
                               replace=False)
        for a, b in pick.reshape(-1, 2):
            out[ids[a]], out[ids[b]] = obs[ids[b]], obs[ids[a]]
        return out


SEQUENCES = {
    # name -> (trajectory file stem, lateral half-width m, sign density,
    #          banner spacing in stations, detection range m)
    # itbt3f: indoor 3rd-floor corridor (near walls — no clutter needed;
    # short detection range, interior lighting);
    # olympic4f: large indoor concourse (columns/booths in the hall,
    # big structures detectable further);
    # myungdong: outdoor market street — dense shopfront signage and
    # overhead street banners (the near-field structure the real scene
    # supplies; without it the wall-only world leaves a yaw/lateral VO
    # ambiguity the real sequence never had — see corridor_segments).
    # The detection range bounds co-visibility (real detectors lose
    # distant lines), which both matches realistic track statistics and
    # makes bag-of-words place recognition spatially discriminative
    # (StereoLineRenderer.max_range).
    # itbt3f's range must cover the corridor turnaround (a 15 m cutoff
    # starves VO of common features there and the replay loses tracking
    # at frame ~308, never reaching the terminal loop closure)
    "itbt3f": ("traj_slslam_itbt3f_basize10_wolc.txt", 3.0, 0.3, 0, 25.0),
    "olympic4f": ("traj_slslam_olympic4f_basize10_wolc.txt",
                  5.0, 0.6, 0, 25.0),
    "myungdong": ("traj_slslam_myungdong_basize10_wolc.txt",
                  7.0, 1.0, 4, 20.0),
}


def real_proxy_workload(sequence: str, max_frames: int | None = None,
                        noise_px: float = 0.5, outlier_frac: float = 0.0,
                        max_gap: int = 5, seed: int = 0, interpolate=False,
                        assigner=None, max_range: float = None,
                        ref_dir: str = REFERENCE_DIR):
    """Build the full proxy workload for a named real sequence.

    max_frames counts KEYFRAMES of the committed trajectory; with
    interpolate=True the returned frames subdivide those keyframe steps to
    video rate (interpolate_poses) and the engine should run its own
    keyframe gates.  Returns (frames, poses_gt, segments, stats) where
    frames are track-id-keyed observation dicts ready for the engines,
    poses_gt the world->camera ground truth per frame, and stats the
    realized workload statistics (obs/frame, churn, track lengths).
    """
    from ..config import CameraConfig
    from .render import StereoLineRenderer
    from .tracks import TrackIdAssigner

    stem, lateral, sign_density, banner_every, seq_range = \
        SEQUENCES[sequence]
    if max_range is None:
        max_range = seq_range
    all_poses = load_reference_poses(f"{ref_dir}/{stem}")
    poses = all_poses[:max_frames] if max_frames else all_poses
    # build the world from a slightly longer pose range so a truncated
    # replay still has scenery ahead of the last camera
    world_poses = all_poses[:max_frames + 15] if max_frames else all_poses
    segs, seg_arcs = corridor_segments(world_poses, lateral=lateral,
                                       seed=seed,
                                       sign_density=sign_density,
                                       banner_every=banner_every,
                                       return_arcs=True)
    if interpolate:
        poses = interpolate_poses(poses)
    ren = StereoLineRenderer(segs, CameraConfig(), noise_px=noise_px,
                             seed=seed, max_range=max_range)
    if assigner is None:
        assigner = TrackIdAssigner(max_gap=max_gap)
    inject = OutlierInjector(outlier_frac, seed=seed + 1) \
        if outlier_frac > 0 else (lambda o: o)

    # Occlusion model: buildings block line of sight between parallel
    # street sections (myungdong's streets run ~13 m apart; itbt3f's
    # corridors ~11 m), but the segment world has no surfaces to
    # raycast.  Approximation: a segment is visible only when its anchor
    # lies within ``max_range`` ALONG THE PATH of the camera's own arc
    # position — you see what is on your stretch of street, not through
    # the block.  On a closed loop the arc metric wraps, so the terminal
    # approach sees the start section exactly as the real camera does
    # (all three sequences end 0.6-4.8 m from their start).
    cam_centers = np.stack([T.inv().t for T in poses])
    steps = np.linalg.norm(np.diff(cam_centers, axis=0), axis=1)
    cam_arc = np.concatenate([[0.0], np.cumsum(steps)])
    wc = np.stack([T.inv().t for T in world_poses])
    total_arc = float(np.sum(np.linalg.norm(np.diff(wc, axis=0), axis=1)))
    closed = np.linalg.norm(wc[-1] - wc[0]) < 5.0

    def arc_visible(i):
        d = np.abs(seg_arcs - cam_arc[i])
        if closed:
            d = np.minimum(d, total_arc - d)
        return d <= max_range

    frames = []
    first_seen: Dict[int, int] = {}
    last_seen: Dict[int, int] = {}
    n_obs = []
    for i, T in enumerate(poses):
        vis = arc_visible(i)
        raw = {sid: o for sid, o in ren.observe(T).items() if vis[sid]}
        obs = assigner.assign(i, inject(raw))
        frames.append(obs)
        n_obs.append(len(obs))
        for tid in obs:
            first_seen.setdefault(tid, i)
            last_seen[tid] = i

    lengths = np.array([last_seen[t] - first_seen[t] + 1
                        for t in first_seen]) if first_seen else np.zeros(1)
    churn = len(first_seen) / max(len(poses), 1)
    stats = dict(
        sequence=sequence,
        num_frames=len(poses),
        num_world_segments=len(segs),
        num_tracks=len(first_seen),
        obs_per_frame_mean=float(np.mean(n_obs)),
        obs_per_frame_min=int(np.min(n_obs)),
        track_len_median=float(np.median(lengths)),
        track_len_p90=float(np.percentile(lengths, 90)),
        new_tracks_per_frame=round(churn, 2),
        outlier_frac=outlier_frac,
        noise_px=noise_px,
    )
    return frames, poses, segs, stats
