"""active-set bookkeeping of the PyTorch port (mirrors
mulactseg_tpu/active)."""

from mulactseg_tpu_torch.active.active_set import RegionActiveSet

__all__ = ["RegionActiveSet"]
