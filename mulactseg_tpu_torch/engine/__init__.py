"""engine of the PyTorch port (mirrors mulactseg_tpu/engine)."""

from mulactseg_tpu_torch.engine.evaluate import Evaluator
from mulactseg_tpu_torch.engine.train import make_train_step

__all__ = ["Evaluator", "make_train_step"]
