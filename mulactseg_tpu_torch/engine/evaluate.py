"""Evaluation loop with streaming mIoU: the port of
mulactseg_tpu/engine/evaluate.py.

Covers plain argmax eval (trainer/base.py:138-175), predignore eval,
which reports mIoU over the C real classes plus a separate IoU of the
undefined class against GT-ignore (trainer/active_joint_multi_predignore.py:
175-216), and sliding-window eval (cfg.sliding_eval, engine/sliding.py;
trainer/eval_slide.py:17-88), which sums the first C channels over the
crop grid and so takes no predignore. The forward runs in eval mode,
under bfloat16 autocast on the card when cfg.dtype == "bfloat16", as the
train step does; uint8 images are normalised on the device.

Under data parallelism (parallel/mesh.py) whole batches go to the ranks
in loader order (DataProvider(split="batches")) and each rank's int64
confusion matrix is summed over the ranks before the mIoU: every rank
reports exactly what one rank counts. The JAX package shards a batch-1
image's height over its mesh instead (its parallel/mesh.py:110-126, with
GSPMD's halo exchanges). A hand-written halo exchange for every dilated
convolution is not worth its cost here: a 1024x2048 image fits one card
(the sliding eval's features peak at 9.53 GiB on an H100, PERF.md).
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from mulactseg_tpu_torch.device import resolve_device
from mulactseg_tpu_torch.engine.train import _device_normalize
from mulactseg_tpu_torch.parallel import mesh
from mulactseg_tpu_torch.utils.metrics import IoUIgnore, MeanIoU


def require_batch_split(loader, who: str) -> None:
    """On several ranks an evaluator counts its own images: its loader
    must be a DataProvider(split="batches")."""
    if mesh.world() > 1 and getattr(loader, "split", None) != "batches":
        raise ValueError(
            f"on {mesh.world()} ranks {who} takes a DataProvider("
            "split='batches'), so that each rank counts its own batches")


def eval_forward(model, images, dev, autocast: bool, **kw):
    """Eval-mode, gradient-free forward of NCHW images (uint8 or float32)
    on `dev`; returns what the model returns (float32 NCHW logits, or
    (feat, logits) with return_feat=True)."""
    images = torch.as_tensor(images).to(dev, non_blocking=True)
    if images.dtype == torch.uint8:
        images = _device_normalize(images)
    model.eval()
    with torch.no_grad(), torch.autocast(dev.type, dtype=torch.bfloat16,
                                         enabled=autocast):
        return model(images, **kw)


class Evaluator:
    def __init__(self, model: torch.nn.Module, cfg, device="cuda"):
        self.model = model
        self.cfg = cfg
        self.dev = resolve_device(device)
        self.autocast = self.dev.type == "cuda" and cfg.dtype == "bfloat16"
        self.sliding = None
        self.confusion = None
        if cfg.sliding_eval:
            from mulactseg_tpu_torch.engine.sliding import SlidingEval

            self.sliding = SlidingEval(
                model, cfg.num_classes, crop_size=cfg.slide_crop,
                stride_rate=cfg.slide_stride_rate, device=self.dev,
                autocast=self.autocast)

    def run(self, model_state, loader: Iterable, *,
            predignore: Optional[bool] = None):
        """model_state: a state_dict to load first, or None to evaluate the
        model's weights as they are. loader yields dicts with 'images'
        (B, 3, H, W) uint8 or normalised float32 and 'labels' (B, H, W)
        int; on several ranks a DataProvider(split="batches"). Returns
        (miou, iou_table_str) like trainer/base.py:161-175, and keeps the
        summed (C, C) confusion matrix in self.confusion."""
        require_batch_split(loader, "Evaluator.run")
        cfg = self.cfg
        if model_state is not None:
            self.model.load_state_dict(model_state)
        if predignore is None:
            predignore = "predignore" in cfg.method
        if self.sliding is not None:
            predignore = False  # the sliding sums hold the C classes only
        iou = MeanIoU(cfg.num_classes, cfg.ignore_idx)
        ign = IoUIgnore(cfg.num_classes, cfg.ignore_idx) if predignore \
            else None
        for batch in loader:
            if self.sliding is not None:
                logits = self.sliding(batch["images"])
            else:
                logits = eval_forward(self.model, batch["images"], self.dev,
                                      self.autocast)
            labels = torch.as_tensor(batch["labels"]).to(self.dev)
            if predignore:
                iou._after_step({"outputs": logits[:, :-1].argmax(1),
                                 "targets": labels})
                ign._after_step({"outputs": logits.argmax(1),
                                 "targets": labels})
            else:
                iou._after_step({"outputs": logits.argmax(1),
                                 "targets": labels})
        iou.all_reduce(self.dev)
        if ign is not None:
            ign.all_reduce(self.dev)
        self.confusion = iou.confusion()
        ious = iou._after_epoch()
        miou = float(np.mean(ious))
        table = [f"{miou:.2f}"] + [f"{v:.2f}" for v in ious]
        if ign is not None:
            table.append(f"{ign._after_epoch():.2f}")
        return miou, ",".join(table)
