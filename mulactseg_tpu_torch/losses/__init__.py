"""losses of the PyTorch port (mirrors mulactseg_tpu/losses)."""
