"""models of the PyTorch port (mirrors mulactseg_tpu/models)."""
