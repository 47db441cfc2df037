"""Optimizer with per-group poly LR: the port of
mulactseg_tpu/engine/state.py:make_optimizer.

AdamW(b1 0.9, b2 0.999, eps 1e-8, weight_decay) with decay on EVERY
parameter (BN and proxy included, as optax.adamw without a mask); the
parameters under the head (`classifier.`) run at cls_lr_scale x the base
LR. Poly LR is evaluated at the step count before the update, with the
min_lr floor NOT scaled by cls_lr_scale (state.py:46). Each group keeps
its base LR (train_lr x lr_mult x its scale; adaptive_train_lr passes the
round index as lr_mult) and the schedule's length (total_itrs, else
cfg.finetune_itrs), as the JAX package's make_optimizer(cfg, total_itrs,
lr_mult).
"""

from __future__ import annotations

from typing import Optional

import torch

from mulactseg_tpu_torch.utils.schedule import poly_lr


def make_optimizer(model: torch.nn.Module, cfg,
                   total_itrs: Optional[int] = None,
                   lr_mult: float = 1.0) -> torch.optim.AdamW:
    if cfg.optimizer != "adamw":
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r}: the port has AdamW only")
    if cfg.scheduler != "poly":
        raise NotImplementedError(
            f"scheduler {cfg.scheduler!r}: the port has poly only")
    head, backbone = [], []
    for name, p in model.named_parameters():
        (head if name.startswith("classifier.") else backbone).append(p)
    base_lr = cfg.train_lr * lr_mult
    total = total_itrs or cfg.finetune_itrs
    opt = torch.optim.AdamW(
        [{"params": backbone, "base_lr": base_lr, "total_itrs": total},
         {"params": head, "base_lr": base_lr * cfg.cls_lr_scale,
          "total_itrs": total}],
        lr=cfg.train_lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=cfg.weight_decay)
    set_lr(opt, cfg, 0)
    return opt


def set_lr(opt: torch.optim.AdamW, cfg, step: int) -> None:
    """Set each group's LR for the update about to be taken at `step`."""
    for g in opt.param_groups:
        g["lr"] = poly_lr(g["base_lr"], g["total_itrs"], cfg.power,
                          cfg.min_lr)(step)
