"""Evaluation loop with streaming mIoU: the port of
mulactseg_tpu/engine/evaluate.py.

Covers plain argmax eval (trainer/base.py:138-175) and predignore eval,
which reports mIoU over the C real classes plus a separate IoU of the
undefined class against GT-ignore (trainer/active_joint_multi_predignore.py:
175-216). The forward runs in eval mode, under bfloat16 autocast on the
card when cfg.dtype == "bfloat16", as the train step does; uint8 images
are normalised on the device.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from mulactseg_tpu_torch.device import resolve_device
from mulactseg_tpu_torch.engine.train import _device_normalize
from mulactseg_tpu_torch.utils.metrics import IoUIgnore, MeanIoU


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
        if cfg.sliding_eval:
            raise NotImplementedError(
                "sliding-window eval (engine/sliding.py) is not ported yet: "
                "ROADMAP.md queue A, item 15")
        self.model = model
        self.cfg = cfg
        self.dev = resolve_device(device)
        self.autocast = self.dev.type == "cuda" and cfg.dtype == "bfloat16"

    def run(self, model_state, loader: Iterable, *,
            predignore: Optional[bool] = None, mesh=None):
        """model_state: a state_dict to load first, or None to evaluate the
        model's weights as they are. loader yields dicts with 'images'
        (B, 3, H, W) uint8 or normalised float32 and 'labels' (B, H, W)
        int. Returns (miou, iou_table_str) like trainer/base.py:161-175."""
        if mesh is not None:
            raise NotImplementedError(
                "spatially sharded eval over a device mesh is not ported "
                "yet: ROADMAP.md queue A, item 17")
        cfg = self.cfg
        if model_state is not None:
            self.model.load_state_dict(model_state)
        if predignore is None:
            predignore = "predignore" in cfg.method
        iou = MeanIoU(cfg.num_classes, cfg.ignore_idx)
        ign = IoUIgnore(cfg.num_classes, cfg.ignore_idx) if predignore \
            else None
        for batch in loader:
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
        ious = iou._after_epoch()
        miou = float(np.mean(ious))
        table = [f"{miou:.2f}"] + [f"{v:.2f}" for v in ious]
        if ign is not None:
            table.append(f"{ign._after_epoch():.2f}")
        return miou, ",".join(table)
