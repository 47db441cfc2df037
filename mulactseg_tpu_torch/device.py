"""Device resolution for every entry point of the port.

Entry points take `device=`, defaulting to "cuda". Without a card a
"cuda" request raises; nothing moves to the CPU unless the caller passes
device="cpu" (as the CPU tests do).

Numerics on the card are set explicitly here: TF32 is OFF for float32
matmuls and for cuDNN float32 convolutions, so any float32 work keeps full
precision. The training conv stack runs under bfloat16 autocast
(engine/train.py), matching the JAX package's cfg.dtype="bfloat16" with
float32 parameters, so TF32 would only affect the float32 tail (the
weight-normalised head and the loss), where the reference runs float32.
"""

from __future__ import annotations

import torch


def set_numerics() -> None:
    """State and set both TF32 switches (off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly to run on the CPU")
        set_numerics()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
