"""Stage-1 training step: the port of mulactseg_tpu/engine/train.py for the
fused lossdecomp criterion.

One eager step per call: forward (BN in train mode, conv stack under
bfloat16 autocast on the card as cfg.dtype="bfloat16" asks), the criterion
on the float32 NCHW logits, backward, AdamW with per-group poly LR. The
JAX package's K-step lax.scan only hides TPU dispatch latency and has no
counterpart here.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from mulactseg_tpu_torch.data.constants import IMAGENET_MEAN, IMAGENET_STD
from mulactseg_tpu_torch.device import resolve_device
from mulactseg_tpu_torch.engine.state import make_optimizer, set_lr
from mulactseg_tpu_torch.losses.fused import lossdecomp_fused
from mulactseg_tpu_torch.models.layers import Dropout, bn_frozen


def _zero_if_nan(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _lossdecomp_loss(cfg):
    def fn(logits, batch):
        if "target_bits" not in batch:
            raise KeyError("the port's lossdecomp criterion is the fused "
                           "path and needs batch['target_bits'] "
                           "(losses/fused.pixel_target_bits)")
        total, aux = lossdecomp_fused(
            logits, batch["target_bits"], batch["target"], batch["spx"],
            nseg=cfg.nseg, coeff=cfg.coeff, coeff_mc=cfg.coeff_mc,
            coeff_gm=cfg.coeff_gm, multi_ce_temp=cfg.multi_ce_temp,
            group_ce_temp=cfg.group_ce_temp)
        return _zero_if_nan(total), aux
    return fn


CRITERIA: Dict[str, Callable] = {
    "active_joint_multi_predignore_lossdecomp": _lossdecomp_loss,
}


def get_criterion(cfg):
    if cfg.method not in CRITERIA:
        raise KeyError(
            f"method {cfg.method!r} has no registered criterion in the port; "
            f"available: {sorted(CRITERIA)}")
    return CRITERIA[cfg.method](cfg)


def _device_normalize(x):
    """uint8 NCHW images -> ImageNet-normalised float32, same op order as
    the JAX package's _device_normalize (train.py:554-563)."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)[None, :, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=x.device)[None, :, None, None]
    return (x.float() / 255.0 - mean) / std


def make_train_step(model: torch.nn.Module, cfg, device="cuda",
                    generator: Optional[torch.Generator] = None):
    """Returns step(batch) -> aux dict of detached loss tensors (no host
    sync). batch: 'images' (B, 3, H, W) float32 or uint8, 'target_bits'
    (B, H, W) int32, 'target' (B, nseg, C) float32, 'spx' (B, H, W) int.
    The step count, the optimizer (step.optimizer) and the dropout
    generator live on the returned function."""
    dev = resolve_device(device)
    criterion = get_criterion(cfg)
    opt = make_optimizer(model, cfg)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    autocast = dev.type == "cuda" and cfg.dtype == "bfloat16"

    def step(batch):
        batch = {k: torch.as_tensor(v).to(dev, non_blocking=True)
                 for k, v in batch.items()}
        images = batch["images"]
        if images.dtype == torch.uint8:
            images = _device_normalize(images)
        model.train()
        set_lr(opt, cfg, step.step)
        with bn_frozen(model, cfg.freeze_bn), torch.autocast(
                dev.type, dtype=torch.bfloat16, enabled=autocast):
            logits = model(images)
        total, aux = criterion(logits, batch)
        opt.zero_grad(set_to_none=True)
        total.backward()
        opt.step()
        step.step += 1
        return {k: v.detach() for k, v in aux.items()}

    step.step = 0
    step.optimizer = opt
    return step
