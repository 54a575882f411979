"""Wave ground-truth trajectory generator.

A copy of ``slslam_tpu/sim/wave.py``: a smooth orbit around the house with a
sinusoidal height "wave", camera always looking at the house center, 400
poses by default (the reference's committed sim result trajectories have
400 rows, matlab_script/result_comp_ancdir_orthonorm/trajectory_*.txt).

Conventions: world z up; camera x right, y down, z forward (optical axis).
Returned poses are world->camera (the engine's kf.T convention).
"""

from __future__ import annotations

import numpy as np

from ..hostgeom import Pose


def look_at(pos, target, up=(0.0, 0.0, 1.0)):
    """World->camera pose for a camera at `pos` looking at `target`."""
    pos = np.asarray(pos, float)
    f = np.asarray(target, float) - pos
    f = f / np.linalg.norm(f)
    up = np.asarray(up, float)
    r = np.cross(f, up)
    r = r / np.linalg.norm(r)
    d = np.cross(f, r)               # camera "down" (y axis)
    R_c2w = np.stack([r, d, f], axis=1)
    R = R_c2w.T
    return Pose(R, -R @ pos)


def wave_trajectory(num_frames=400, radius=6.0, center=(0.0, 5.0, 1.2),
                    height=1.5, wave_amp=0.4, wave_cycles=6, arc=1.5 * np.pi,
                    start_angle=-0.5 * np.pi):
    """List of world->camera Pose, orbiting `center` with a height wave."""
    center = np.asarray(center, float)
    poses = []
    for i in range(num_frames):
        phi = start_angle + arc * i / max(num_frames - 1, 1)
        z = height + wave_amp * np.sin(wave_cycles * arc * i /
                                       max(num_frames - 1, 1))
        pos = center + np.array([radius * np.cos(phi),
                                 radius * np.sin(phi), 0.0])
        pos[2] = z
        poses.append(look_at(pos, center))
    return poses
