"""Multi-scale + flip test-time augmentation (TTA): the port of
mulactseg_tpu/engine/tta.py, which the VOC pseudo-labeller runs
(trainer/eval_save_cosplbl_prop_includeonehot_voc_ms.py:53-80 in the
reference: 5 scales x flip, features and logits averaged after resizing
back).

Each view is resized (bilinear, half-pixel centres, no antialias: the JAX
package's jax.image.resize), flipped, forwarded and un-flipped on the
device; the averaged features are L2-normalised again, with the 1e-12
inside the square root.
"""

from __future__ import annotations

import torch

from mulactseg_tpu_torch.engine.evaluate import eval_forward
from mulactseg_tpu_torch.engine.train import _device_normalize
from mulactseg_tpu_torch.models.layers import resize_bilinear

TTA_SCALES = (0.5, 0.75, 1.0, 1.25, 1.5)


def tta_feat_forward(model, images, dev, autocast: bool):
    """images (B, 3, H, W), uint8 or normalised float32. Returns (feat
    (B, Ch, H, W) re-normalised, logits (B, C, H, W)), float32, averaged
    over TTA_SCALES x flips. TTA_SCALES is read at call time (tests shrink
    it, as the JAX package's do)."""
    images = torch.as_tensor(images).to(dev, non_blocking=True)
    if images.dtype == torch.uint8:
        images = _device_normalize(images)
    H, W = images.shape[-2:]
    feat_sum = logit_sum = None
    n = 0
    for flip in (False, True):
        for s in TTA_SCALES:
            img = resize_bilinear(images, (int(s * H), int(s * W)))
            if flip:
                img = img.flip(-1)
            feat, logits = eval_forward(model, img, dev, autocast,
                                        return_feat=True)
            if flip:
                feat, logits = feat.flip(-1), logits.flip(-1)
            feat = resize_bilinear(feat.float(), (H, W))
            logits = resize_bilinear(logits.float(), (H, W))
            feat_sum = feat if feat_sum is None else feat_sum + feat
            logit_sum = logits if logit_sum is None else logit_sum + logits
            n += 1
    feat = feat_sum / n
    feat = feat / torch.sqrt(torch.sum(feat * feat, dim=1, keepdim=True)
                             + 1e-12)
    return feat, logit_sum / n
