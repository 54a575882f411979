"""Engines of the PyTorch port (counterparts of slslam_tpu.engine)."""
