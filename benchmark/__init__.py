"""The benchmark of mulactseg_tpu_torch (README.md)."""
