"""Front-end of the port: the reference's observation-file loader (a copy
of slslam_tpu.frontend.io) and the image front-end (detector, MSLD
descriptor, stereo/temporal matcher; ports of slslam_tpu.frontend), which
turns rectified stereo images into line tracks."""

from .io import ObsFileLoader, parse_obs_file  # noqa: F401
