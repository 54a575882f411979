"""Trajectory writers in the reference's exact text format.

A copy of ``write_trajectory`` and ``trajectory_rows`` from
``slslam_tpu/evalio/writers.py``.  Rows (the reference's
src/slam.cpp:1489-1494):
    i  t_z  -t_x  -t_y  w0  w1  w2
where (R, t) is the camera-to-world pose and w its angle-axis.  Drop-in
compatible with the reference's MATLAB evaluation scripts.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..hostgeom import Pose, so3_log


def write_trajectory(path: str, poses_c2w: List[Pose]):
    with open(path, "w") as f:
        for i, T in enumerate(poses_c2w):
            w = so3_log(T.R)
            t = T.t
            f.write(f"{i}\t{t[2]}\t{-t[0]}\t{-t[1]}\t"
                    f"{w[0]}\t{w[1]}\t{w[2]}\n")


def trajectory_rows(poses_c2w: List[Pose]) -> np.ndarray:
    """The same data as write_trajectory, as an (N, 7) array."""
    rows = []
    for i, T in enumerate(poses_c2w):
        w = so3_log(T.R)
        t = T.t
        rows.append([i, t[2], -t[0], -t[1], w[0], w[1], w[2]])
    return np.asarray(rows)
