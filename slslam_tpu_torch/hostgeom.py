"""NumPy (float64) pose algebra of the host side: ``Pose`` and ``so3_log``.

A copy of the parts of ``slslam_tpu/hostgeom.py`` that the port calls
(``Pose``, ``skew``, ``rodrigues``, ``so3_log``), kept here so that the port
imports nothing of the JAX package.  ``tests/test_torch_copies.py`` checks
that the copies agree with the originals.  Reference semantics: the
reference's src/gc.cpp.
"""

from __future__ import annotations

import numpy as np


class Pose:
    """SE(3) pose p_c = R p_w + t (reference pose_t, src/all.h:42-49)."""

    __slots__ = ("R", "t")

    def __init__(self, R=None, t=None):
        self.R = np.eye(3) if R is None else np.asarray(R, dtype=np.float64)
        self.t = np.zeros(3) if t is None else np.asarray(t, dtype=np.float64)

    def inv(self) -> "Pose":
        Ri = self.R.T
        return Pose(Ri, -Ri @ self.t)

    def __matmul__(self, other: "Pose") -> "Pose":
        """T20 = self * other (gc_T_20)."""
        return Pose(self.R @ other.R, self.R @ other.t + self.t)

    def rel_to(self, other: "Pose") -> "Pose":
        """T21 = self * other^-1 (gc_T_21)."""
        return self @ other.inv()

    def copy(self) -> "Pose":
        return Pose(self.R.copy(), self.t.copy())

    def wt(self) -> np.ndarray:
        return np.concatenate([so3_log(self.R), self.t])

    @staticmethod
    def from_wt(wt) -> "Pose":
        wt = np.asarray(wt, dtype=np.float64)
        return Pose(rodrigues(wt[:3]), wt[3:])

    def __repr__(self):
        return f"Pose(w={so3_log(self.R)}, t={self.t})"


def skew(v):
    return np.array([
        [0.0, -v[2], v[1]],
        [v[2], 0.0, -v[0]],
        [-v[1], v[0], 0.0],
    ])


def rodrigues(w):
    """Angle-axis -> rotation matrix."""
    w = np.asarray(w, dtype=np.float64)
    theta2 = float(w @ w)
    W = skew(w)
    if theta2 < 1e-16:
        a = 1.0 - theta2 / 6.0
        b = 0.5 - theta2 / 24.0
    else:
        theta = np.sqrt(theta2)
        a = np.sin(theta) / theta
        b = (1.0 - np.cos(theta)) / theta2
    return np.eye(3) + a * W + b * (W @ W)


def so3_log(R):
    """Rotation matrix -> angle-axis (robust near 0 and pi)."""
    R = np.asarray(R, dtype=np.float64)
    vee = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                          R[1, 0] - R[0, 1]])
    s = np.linalg.norm(vee)
    c = 0.5 * (np.trace(R) - 1.0)
    theta = np.arctan2(s, c)
    if c < -0.99:
        diag = np.diag(R)
        axis2 = np.maximum((diag - c) / (1.0 - c + 1e-300), 0.0)
        axis = np.sqrt(axis2)
        sgn = np.sign(np.where(np.abs(vee) > 1e-12, vee, 1.0))
        axis = axis * sgn
        axis /= (np.linalg.norm(axis) + 1e-300)
        return theta * axis
    if s < 1e-8:
        return (1.0 + (1.0 - c) / 6.0) * vee
    return (theta / s) * vee
