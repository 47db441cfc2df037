"""Region acquisition of the PyTorch port (mirrors
mulactseg_tpu/acquisition): scoring and the selectors."""

from mulactseg_tpu_torch.acquisition.selectors import SELECTORS, get_selector

__all__ = ["get_selector", "SELECTORS"]
