"""ops of the PyTorch port (mirrors mulactseg_tpu/ops)."""
