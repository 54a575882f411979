"""The house simulation of the port (copied from slslam_tpu.sim): the
74-segment house world, the wave trajectory and the stereo line renderer."""

from .house import house_segments  # noqa: F401
from .render import StereoLineRenderer  # noqa: F401
from .wave import wave_trajectory  # noqa: F401
