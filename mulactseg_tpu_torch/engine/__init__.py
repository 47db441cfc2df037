"""engine of the PyTorch port (mirrors mulactseg_tpu/engine)."""
