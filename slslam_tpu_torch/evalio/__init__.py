"""Trajectory and landmark writers and the ATE metric of the port (copied
from slslam_tpu.evalio)."""

from .traj import ate_position_error  # noqa: F401
from .writers import (trajectory_rows, write_landmarks,  # noqa: F401
                      write_trajectory)
