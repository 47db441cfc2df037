"""Training and eval steps: the port of mulactseg_tpu/engine/train.py for
the recipes' criteria, the fused lossdecomp of stage 1
(active_joint_multi_predignore_lossdecomp on Cityscapes' C+1-class model,
active_joint_multi_lossdecomp on VOC's 21-class one) and the plain
temperature CE of stage 2 (active_predignore; active on VOC).

One eager step per call: forward (BN in train mode, conv stack under
bfloat16 autocast on the card as cfg.dtype="bfloat16" asks), the criterion
on the float32 NCHW logits, backward, AdamW with per-group poly LR. The
step moves to the device only the images and the keys its criterion
reads. The JAX package's K-step lax.scan only hides TPU dispatch latency
and has no counterpart here.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from mulactseg_tpu_torch.data.constants import IMAGENET_MEAN, IMAGENET_STD
from mulactseg_tpu_torch.device import resolve_device
from mulactseg_tpu_torch.engine.state import make_optimizer, set_lr
from mulactseg_tpu_torch.losses.fused import lossdecomp_fused
from mulactseg_tpu_torch.losses.standard import cross_entropy
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
    fn.keys = ("target_bits", "target", "spx")
    return fn


def _ce_loss(cfg):
    """Stage 2: CE on the pseudo-label maps (train.py:108-113)."""
    def fn(logits, batch):
        loss = cross_entropy(logits, batch["labels"], temp=cfg.ce_temp,
                             ignore_index=cfg.ignore_idx)
        return loss, {"train_loss": loss}
    fn.keys = ("labels",)
    return fn


CRITERIA: Dict[str, Callable] = {
    "active_joint_multi_predignore_lossdecomp": _lossdecomp_loss,
    "active_joint_multi_lossdecomp": _lossdecomp_loss,
    "active_predignore": _ce_loss,
    "active": _ce_loss,
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
                    generator: Optional[torch.Generator] = None,
                    optimizer: Optional[torch.optim.Optimizer] = None):
    """Returns step(batch) -> aux dict of detached loss tensors (no host
    sync). batch: 'images' (B, 3, H, W) float32 or uint8 and the
    criterion's keys: for lossdecomp 'target_bits' (B, H, W) int32,
    'target' (B, nseg, C) float32 and 'spx' (B, H, W) int; for CE
    'labels' (B, H, W) int. Other keys stay on the host. `optimizer`
    defaults to make_optimizer(model, cfg). The step count (step.step,
    which sets the poly LR; a caller restoring a checkpoint sets it), the
    optimizer (step.optimizer) and the dropout generator live on the
    returned function."""
    dev = resolve_device(device)
    criterion = get_criterion(cfg)
    opt = optimizer if optimizer is not None else make_optimizer(model, cfg)
    keys = ("images",) + criterion.keys
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    autocast = dev.type == "cuda" and cfg.dtype == "bfloat16"

    def step(batch):
        batch = {k: torch.as_tensor(batch[k]).to(dev, non_blocking=True)
                 for k in keys if k in batch}
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


def make_eval_step(model: torch.nn.Module, cfg, device="cuda"):
    """Returns predict(images) -> eval-mode float32 NCHW logits on the
    device (train.py:677-684): images (B, 3, H, W) uint8 or normalised
    float32, the forward under bfloat16 autocast on the card when
    cfg.dtype == "bfloat16"."""
    from mulactseg_tpu_torch.engine.evaluate import eval_forward

    dev = resolve_device(device)
    autocast = dev.type == "cuda" and cfg.dtype == "bfloat16"

    def predict(images):
        return eval_forward(model, images, dev, autocast)

    return predict
