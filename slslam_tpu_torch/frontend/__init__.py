"""Front-end of the port: the reference's observation-file loader (a copy
of slslam_tpu.frontend.io; the detector, matcher and descriptors are P11,
not ported yet)."""

from .io import ObsFileLoader, parse_obs_file  # noqa: F401
