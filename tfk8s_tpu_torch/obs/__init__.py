"""obs of the PyTorch port (mirrors tfk8s_tpu/obs)."""
