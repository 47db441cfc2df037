"""utils of the PyTorch port (mirrors mulactseg_tpu/utils)."""

from mulactseg_tpu_torch.utils.metrics import (
    IoUIgnore,
    MeanIoU,
    confusion_matrix,
)

__all__ = ["IoUIgnore", "MeanIoU", "confusion_matrix"]
