"""models of the PyTorch port (mirrors tfk8s_tpu/models)."""
