"""Solver ops of the PyTorch port (counterparts of slslam_tpu.ops)."""
