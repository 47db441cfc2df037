"""PyTorch/CUDA port of mulactseg_tpu for one NVIDIA H100.

The JAX package beside it is the reference; this package imports nothing
of it. Layout mirrors mulactseg_tpu (models/, ops/, losses/, engine/,
data/, utils/). Hand-written CUDA kernels live in csrc/ and are built on
first use by ops/_build.py.
"""

from mulactseg_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
