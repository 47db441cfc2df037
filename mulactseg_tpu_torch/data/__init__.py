"""data of the PyTorch port (mirrors mulactseg_tpu/data)."""
