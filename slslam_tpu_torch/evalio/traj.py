"""Trajectory evaluation: the reference's ATE metric.

A copy of ``slslam_tpu/evalio/traj.py`` (matlab_script/calc_traj_err.m:
27-40: the unaligned mean per-row position error between two trajectory
files, no SE(3) alignment; the literal cols-1:3 variant; the heading
alignment of plot_trajectory.m).  ``tests/test_torch_copies.py`` checks the
copy against the original.
"""

from __future__ import annotations

import numpy as np


def load_trajectory(path: str) -> np.ndarray:
    return np.loadtxt(path)


def ate_position_error(traj_a: np.ndarray, traj_b: np.ndarray,
                       cols=(1, 2, 3)) -> float:
    """Mean per-row Euclidean error over the shared prefix.

    cols: which columns hold positions.  (1, 2, 3) matches the
    save_trajectory format (t_z, -t_x, -t_y).
    """
    n = min(len(traj_a), len(traj_b))
    d = traj_a[:n][:, list(cols)] - traj_b[:n][:, list(cols)]
    return float(np.mean(np.linalg.norm(d, axis=1)))


def ate_matlab_literal(traj_a: np.ndarray, traj_b: np.ndarray) -> float:
    """The literal calc_traj_err.m computation (columns 1:3 MATLAB,
    i.e. 0:3 python — includes the frame-index column)."""
    n = min(len(traj_a), len(traj_b))
    d = traj_a[:n, 0:3] - traj_b[:n, 0:3]
    return float(np.mean(np.linalg.norm(d, axis=1)))


def align_heading(rows: np.ndarray, heading_row: int = 9,
                  cols=(1, 2, 3)) -> np.ndarray:
    """Rotate a trajectory so an early heading maps onto +x.

    The reference's real-sequence comparison protocol
    (matlab_script/plot_trajectory.m:47-69 for itbt3f with row 10,
    :113-133 for myungdong with row 50; MATLAB is 1-indexed so the python
    defaults differ by one): take the position of ``heading_row`` as the
    new x axis, build y by rotating it -90 deg about z, z by the cross
    product, and express all positions in that frame.  Needed before any
    ATE comparison of trajectories with arbitrary initial heading (e.g.
    slslam vs ScaViSLAM runs of the same sequence).

    rows: (N, >=4) trajectory rows; cols selects the position columns.
    Returns (N, 3) aligned positions.
    """
    pos = np.asarray(rows)[:, list(cols)].astype(np.float64)
    newx = pos[heading_row].copy()
    rot_z = np.array([[0.0, 1.0, 0.0],
                      [-1.0, 0.0, 0.0],
                      [0.0, 0.0, 1.0]])
    newy = rot_z.T @ newx
    newz = np.cross(newx, newy)
    n = np.linalg.norm
    if n(newx) == 0 or n(newz) == 0:
        return pos
    R = np.stack([newx / n(newx), newy / n(newy), newz / n(newz)], axis=1)
    return pos @ R  # == (R' @ pos')'


def ate_aligned(traj_a: np.ndarray, traj_b: np.ndarray,
                heading_row: int = 9, cols=(1, 2, 3)) -> float:
    """Mean position error after aligning both trajectories' early heading
    onto +x (plot_trajectory.m protocol) — the metric for comparing runs
    whose world frames differ by an initial rotation."""
    a = align_heading(traj_a, heading_row, cols)
    b = align_heading(traj_b, heading_row, cols)
    n = min(len(a), len(b))
    return float(np.mean(np.linalg.norm(a[:n] - b[:n], axis=1)))
