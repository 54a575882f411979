"""Village world: a ring of houses for loop-closure-scale simulation (copied
from slslam_tpu/sim/village.py; tests/test_torch_copies.py holds it to the
original).

The single house (house.py) is visible from every viewpoint, which makes
place recognition degenerate (all frames look alike) and keeps feature
tracks alive forever.  A ring of houses gives viewpoint-distinct scenery:
the camera orbits inside the ring looking outward, sees 1-2 houses at a
time, loses them, and re-sees them on revisit — the loop-closure workload.
"""

from __future__ import annotations

import numpy as np

from .house import house_segments
from .wave import look_at


def _transform_segments(segs, yaw, tx, ty):
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s], [s, c]])
    out = segs.copy()
    for off in (0, 3):
        xy = out[:, off:off + 2] @ R.T
        out[:, off] = xy[:, 0] + tx
        out[:, off + 1] = xy[:, 1] + ty
    return out


def village_segments(n_houses: int = 8, ring_radius: float = 10.0):
    """(n_houses * 74, 6) segments: houses on a ring, each facing center.

    House local frame (after house.py's shift): spans x in [-2.25, 2.25],
    y in [2.75, 7.25].  We first re-center it to the origin, then place its
    center at ring_radius along each spoke, front wall facing inward.
    """
    base = house_segments()
    base = base.copy()
    base[:, [1, 4]] -= 5.0          # recenter y to [-2.25, 2.25]
    all_segs = []
    for k in range(n_houses):
        ang = 2 * np.pi * k / n_houses
        # front wall (local -y side) should face the ring center
        yaw = ang + np.pi / 2
        tx = ring_radius * np.cos(ang)
        ty = ring_radius * np.sin(ang)
        all_segs.append(_transform_segments(base, yaw, tx, ty))
    return np.concatenate(all_segs)


def village_trajectory(num_frames=240, orbit_radius=4.0, height=1.5,
                       wave_amp=0.3, wave_cycles=6, arc=2.0 * np.pi,
                       start_angle=0.0, look_out_radius=30.0):
    """Camera orbits inside the ring looking outward at the houses."""
    poses = []
    for i in range(num_frames):
        phi = start_angle + arc * i / max(num_frames - 1, 1)
        z = height + wave_amp * np.sin(wave_cycles * arc * i /
                                       max(num_frames - 1, 1))
        pos = np.array([orbit_radius * np.cos(phi),
                        orbit_radius * np.sin(phi), z])
        target = np.array([look_out_radius * np.cos(phi),
                           look_out_radius * np.sin(phi), height])
        poses.append(look_at(pos, target))
    return poses
