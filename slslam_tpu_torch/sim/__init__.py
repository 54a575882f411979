"""The simulations of the port (copied from slslam_tpu.sim): the
74-segment house world, the wave trajectory, the stereo line renderer, the
front-end's stereo image renderer, and the loop-closure workload's village
ring, orbit, track-id churn and descriptor source."""

from .house import house_segments  # noqa: F401
from .images import StereoImageRenderer, draw_segments  # noqa: F401
from .render import StereoLineRenderer  # noqa: F401
from .tracks import SegmentDescriptorSource, TrackIdAssigner  # noqa: F401
from .village import village_segments, village_trajectory  # noqa: F401
from .wave import wave_trajectory  # noqa: F401
