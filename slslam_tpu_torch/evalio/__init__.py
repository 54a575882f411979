"""Trajectory writers of the port (copied from slslam_tpu.evalio)."""

from .writers import trajectory_rows, write_trajectory  # noqa: F401
