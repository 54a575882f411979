"""Engines of the PyTorch port (counterparts of slslam_tpu.engine): the
interactive ``Slam``, the batch replay, the global refine and the deferred
loop closure."""

from .slam import Slam  # noqa: F401
