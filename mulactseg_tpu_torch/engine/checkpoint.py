"""Checkpoints: the port of mulactseg_tpu/engine/checkpoint.py.

One torch.save file per checkpoint, in the reference's round-checkpoint
layout (trainer/base.py:281-294): 'model_state_dict' under the reference
torch names (so the JAX package's models/torch_import.py reads it),
'optimizer_state_dict' and 'step'. The file names are the JAX package's
(checkpointNN, stage2_checkpointNN; no extension). Readers take the
optimizer state from 'optimizer_state_dict' or, in files the reference
wrote, 'opt_state_dict' (optimizer_state).

merge_pretrained is the reference's "ImageNet init with the classifier
stripped" load (trainer/active_joint_multi_predignore.py:146-173): every
pretrained entry whose name exists with the same shape is copied, except
the final classifier weights (classifier.final.* and classifier.proxy).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from mulactseg_tpu_torch.parallel import mesh


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    step: int = 0) -> None:
    """Write atomically: to a temporary name, then rename over `path`.
    Under data parallelism every rank calls this: rank 0 writes (the
    ranks hold the same weights) and every rank waits at a barrier until
    the file is there."""
    if mesh.is_main():
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {
            "model_state_dict": {k: v.detach().cpu()
                                 for k, v in model.state_dict().items()},
            "optimizer_state_dict": (optimizer.state_dict()
                                     if optimizer is not None else None),
            "step": int(step),
        }
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    mesh.barrier()


def load_checkpoint(path: str) -> Dict:
    """The payload dict, every tensor on the CPU."""
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def optimizer_state(payload: Dict) -> Optional[Dict]:
    """The optimizer state of a checkpoint payload: 'optimizer_state_dict'
    (the port's files) or 'opt_state_dict' (the reference's,
    trainer/base.py:281-294); None when it holds neither."""
    for key in ("optimizer_state_dict", "opt_state_dict"):
        if payload.get(key):
            return payload[key]
    return None


def _is_classifier_final(name: str) -> bool:
    return name.startswith("classifier.") and (
        "final" in name or name.rsplit(".", 1)[-1] == "proxy")


def merge_pretrained(fresh: Dict[str, torch.Tensor],
                     pretrained: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Non-strict load: a copy of `fresh` with every `pretrained` entry
    whose name exists in it with a matching shape, except the final
    classifier weights, which stay fresh."""
    out = dict(fresh)
    for k, v in pretrained.items():
        if _is_classifier_final(k):
            continue
        if k in fresh and tuple(fresh[k].shape) == tuple(v.shape):
            out[k] = v
    return out
