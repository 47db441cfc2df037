"""Optimizer with per-group LR schedules: the port of
mulactseg_tpu/engine/state.py:make_optimizer.

AdamW(b1 0.9, b2 0.999, eps 1e-8, weight_decay) with decay on EVERY
parameter (BN and proxy included, as optax.adamw without a mask), or SGD
with momentum 0.9 (optax.chain(add_decayed_weights(wd), sgd(lr,
momentum=0.9)), which is torch's SGD with weight_decay, no dampening and
no Nesterov); the parameters under the head (`classifier.`) run at
cls_lr_scale x the base LR. The schedule is poly (cfg.scheduler ==
"poly"), evaluated at the step count before the update with the min_lr
floor NOT scaled by cls_lr_scale (state.py:46), or else constant at the
group's base LR, with no floor. Each group keeps its base LR (train_lr x
lr_mult x its scale; adaptive_train_lr passes the round index as
lr_mult) and the schedule's length (total_itrs, else cfg.finetune_itrs),
as the JAX package's make_optimizer(cfg, total_itrs, lr_mult).

On a card, AdamW is built with capturable=True and each group's LR in a
float32 tensor on the parameters' device, which set_lr fills in place:
the update then reads no Python number, so engine/train.py can replay it
inside a CUDA graph, and the eager steps take the same update. The CPU
and SGD keep Python-float LRs.
"""

from __future__ import annotations

from typing import Optional

import torch

from mulactseg_tpu_torch.utils.schedule import poly_lr


def make_optimizer(model: torch.nn.Module, cfg,
                   total_itrs: Optional[int] = None,
                   lr_mult: float = 1.0) -> torch.optim.Optimizer:
    head, backbone = [], []
    for name, p in model.named_parameters():
        (head if name.startswith("classifier.") else backbone).append(p)
    base_lr = cfg.train_lr * lr_mult
    total = total_itrs or cfg.finetune_itrs
    groups = [{"params": backbone, "base_lr": base_lr, "total_itrs": total},
              {"params": head, "base_lr": base_lr * cfg.cls_lr_scale,
               "total_itrs": total}]
    dev = next(model.parameters()).device
    if cfg.optimizer == "adamw":
        opt = torch.optim.AdamW(groups, lr=cfg.train_lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=cfg.weight_decay,
                                capturable=dev.type == "cuda")
        if dev.type == "cuda":
            for g in opt.param_groups:
                g["lr"] = torch.zeros((), device=dev)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(groups, lr=cfg.train_lr, momentum=0.9,
                              dampening=0.0, nesterov=False,
                              weight_decay=cfg.weight_decay)
    else:
        raise NotImplementedError(f"optimizer {cfg.optimizer!r}")
    set_lr(opt, cfg, 0)
    return opt


def set_lr(opt: torch.optim.Optimizer, cfg, step: int) -> None:
    """Set each group's LR for the update about to be taken at `step`: a
    device LR tensor is filled in place (no host read), a float
    replaced."""
    for g in opt.param_groups:
        if cfg.scheduler == "poly":
            lr = poly_lr(g["base_lr"], g["total_itrs"], cfg.power,
                         cfg.min_lr)(step)
        else:
            lr = g["base_lr"]
        if isinstance(g["lr"], torch.Tensor):
            g["lr"].fill_(lr)
        else:
            g["lr"] = lr


def device_lrs(opt: torch.optim.Optimizer) -> bool:
    """Whether every group's LR lives in a device tensor (make_optimizer's
    AdamW on a card), so the update can be replayed in a CUDA graph."""
    return all(isinstance(g["lr"], torch.Tensor) and g.get("capturable")
               for g in opt.param_groups)
