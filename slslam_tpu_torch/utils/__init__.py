"""Host utilities of the port (copies of slslam_tpu.utils' jax-free parts)."""
