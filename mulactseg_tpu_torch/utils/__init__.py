"""utils of the PyTorch port (mirrors mulactseg_tpu/utils)."""
