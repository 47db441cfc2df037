"""Device resolution for every entry point of the port.

Entry points take `device=`, defaulting to "cuda". Without a card a
"cuda" request raises; nothing moves to the CPU unless the caller passes
device="cpu" (as the CPU tests do). Inside a process group (one rank per
card, parallel/mesh.py) "cuda" is this rank's card, cuda:LOCAL_RANK; an
explicit index ("cuda:0") is honoured, so several ranks may share a card.

Numerics on the card are set explicitly here: TF32 is OFF for float32
matmuls and for cuDNN float32 convolutions, so any float32 work keeps full
precision. The training conv stack runs under bfloat16 autocast
(engine/train.py), matching the JAX package's cfg.dtype="bfloat16" with
float32 parameters, so TF32 would only affect the float32 tail (the
weight-normalised head and the loss), where the reference runs float32.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def set_numerics() -> None:
    """State and set both TF32 switches (off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def bf16_autocast(dev: torch.device, cfg) -> bool:
    """Whether a forward on `dev` runs under bfloat16 autocast for cfg: on
    the card when cfg.dtype == "bfloat16"; the CPU computes in float32."""
    return dev.type == "cuda" and cfg.dtype == "bfloat16"


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly to run on the CPU")
        if dev.index is None and dist.is_available() and \
                dist.is_initialized():
            dev = torch.device("cuda", local_rank())
        set_numerics()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def local_rank() -> int:
    """This rank's card: torchrun's LOCAL_RANK, which must name a card of
    this host (it never wraps round onto another rank's card)."""
    if "LOCAL_RANK" not in os.environ:
        raise RuntimeError(
            "LOCAL_RANK is not set: start the ranks with torchrun or "
            "mulactseg_tpu_torch.parallel.spawn, or pass device='cuda:<i>'")
    local = int(os.environ["LOCAL_RANK"])
    count = torch.cuda.device_count()
    if not 0 <= local < count:
        raise RuntimeError(
            f"LOCAL_RANK {local}, but this host has {count} CUDA device(s): "
            "start at most one rank per card, or pass device='cuda:<i>'")
    return local
