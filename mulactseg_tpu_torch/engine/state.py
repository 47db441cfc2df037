"""Optimizer with per-group poly LR: the port of
mulactseg_tpu/engine/state.py:make_optimizer.

AdamW(b1 0.9, b2 0.999, eps 1e-8, weight_decay) with decay on EVERY
parameter (BN and proxy included, as optax.adamw without a mask); the
parameters under the head (`classifier.`) run at cls_lr_scale x the base
LR. Poly LR is evaluated at the step count before the update, with the
min_lr floor NOT scaled by cls_lr_scale (state.py:46).
"""

from __future__ import annotations

import torch

from mulactseg_tpu_torch.utils.schedule import poly_lr


def make_optimizer(model: torch.nn.Module, cfg) -> torch.optim.AdamW:
    if cfg.optimizer != "adamw":
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r}: the port has AdamW only")
    if cfg.scheduler != "poly":
        raise NotImplementedError(
            f"scheduler {cfg.scheduler!r}: the port has poly only")
    head, backbone = [], []
    for name, p in model.named_parameters():
        (head if name.startswith("classifier.") else backbone).append(p)
    opt = torch.optim.AdamW(
        [{"params": backbone, "lr_scale": 1.0},
         {"params": head, "lr_scale": cfg.cls_lr_scale}],
        lr=cfg.train_lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=cfg.weight_decay)
    set_lr(opt, cfg, 0)
    return opt


def set_lr(opt: torch.optim.AdamW, cfg, step: int) -> None:
    """Set each group's LR for the update about to be taken at `step`."""
    for g in opt.param_groups:
        g["lr"] = poly_lr(cfg.train_lr * g["lr_scale"], cfg.finetune_itrs,
                          cfg.power, cfg.min_lr)(step)
