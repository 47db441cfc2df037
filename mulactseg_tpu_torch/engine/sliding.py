"""Sliding-window evaluation: the port of mulactseg_tpu/engine/sliding.py
(the reference's utils/sliding_evaluator.py:73-135: crop 800, stride 2/3,
windows clamped to the padded image, logits summed over the overlaps).
The reference keeps a count map and never divides by it, and neither does
this copy.

The image is normalised on the device (uint8 in) and centre-padded with
zeros where it is smaller than a crop (VOC's 500x375 images). The
windows go through the eval forward in batches of up to
WINDOWS_PER_FORWARD crops (BN is in eval mode, so a crop's output does
not depend on its batch; the recipe's 8 windows of 800x800 take one),
and their outputs are added into a float32 accumulator one window at a
time, in the grid's order, as the JAX package's scan does.

With return_feat it is the utils/sliding_evaluator_plbl.py:16-29 twin:
the decoder's features are summed beside the logits, both float32, and
the features are L2-renormalised with max(norm, 1e-12) at the end.
"""

from __future__ import annotations

import math

import torch

from mulactseg_tpu_torch.device import resolve_device
from mulactseg_tpu_torch.engine.evaluate import eval_forward
from mulactseg_tpu_torch.engine.train import _device_normalize

WINDOWS_PER_FORWARD = 8


def _window_grid(H, W, crop, stride_rate):
    """(padH, padW, [(y0, x0), ...]) of the crop grid, row by row."""
    ch = cw = crop
    padH, padW = max(H, ch), max(W, cw)
    s = int(math.ceil(crop * stride_rate))
    rg = int(math.ceil((padH - ch) / s)) + 1
    cg = int(math.ceil((padW - cw) / s)) + 1
    pos = []
    for gy in range(rg):
        for gx in range(cg):
            ey = min(gy * s + ch, padH)
            ex = min(gx * s + cw, padW)
            pos.append((ey - ch, ex - cw))
    return padH, padW, pos


class SlidingEval:
    """Callable images (B, 3, H, W), uint8 or normalised float32 ->
    logits (B, C, H, W) float32 summed over the crop grid, the first
    num_classes channels; with return_feat, (feat (B, Ch, H, W)
    renormalised, logits (B, C_model, H, W)), every channel of the
    model's logits, as the JAX package's twin keeps them."""

    def __init__(self, model, num_classes: int, crop_size: int = 800,
                 stride_rate: float = 2 / 3, return_feat: bool = False,
                 *, device="cuda", autocast: bool = False):
        self.model = model
        self.num_classes = num_classes
        self.crop = crop_size
        self.stride_rate = stride_rate
        self.return_feat = return_feat
        self.dev = resolve_device(device)
        self.autocast = autocast
        self.windows = 0  # windows of the last call's grid

    def __call__(self, images):
        images = torch.as_tensor(images).to(self.dev, non_blocking=True)
        if images.dtype == torch.uint8:
            images = _device_normalize(images)
        B, _, H, W = images.shape
        crop = self.crop
        padH, padW, pos = _window_grid(H, W, crop, self.stride_rate)
        self.windows = len(pos)
        ph, pw = padH - H, padW - W
        img = torch.nn.functional.pad(
            images, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        accs = None
        per = max(1, WINDOWS_PER_FORWARD // B)
        for lo in range(0, len(pos), per):
            chunk = pos[lo:lo + per]
            crops = torch.cat([img[:, :, y:y + crop, x:x + crop]
                               for y, x in chunk])
            out = eval_forward(self.model, crops, self.dev, self.autocast,
                               return_feat=self.return_feat)
            # (logits, feat) with return_feat, else (logits,)
            parts = (out[1], out[0]) if self.return_feat else \
                (out[:, :self.num_classes],)
            if accs is None:
                accs = [torch.zeros((B, p.shape[1], padH, padW),
                                    dtype=torch.float32, device=self.dev)
                        for p in parts]
            for acc, part in zip(accs, parts):
                for i, (y, x) in enumerate(chunk):
                    acc[:, :, y:y + crop, x:x + crop] += \
                        part[i * B:(i + 1) * B].float()
            del out, parts
        accs = [a[:, :, ph // 2:ph // 2 + H, pw // 2:pw // 2 + W]
                for a in accs]
        if not self.return_feat:
            return accs[0]
        logits, feat = accs
        norm = torch.linalg.vector_norm(feat, dim=1, keepdim=True)
        return feat / norm.clamp_min(1e-12), logits
