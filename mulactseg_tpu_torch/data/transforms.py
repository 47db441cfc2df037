"""ImageNet normalisation of uint8 images: the port's copy of
`normalize` in mulactseg_tpu/data/transforms.py:104. The rest of that
module (the random scale, crop and flip transforms) imports Pillow and is
not ported yet (ROADMAP.md queue A, item 10).

Each channel goes through a 256-entry table built by the same float32
operations as the JAX package's, so each value is bitwise the JAX
package's; the output is channel-first, the port's layout.
"""

from __future__ import annotations

import numpy as np

from mulactseg_tpu_torch.data.constants import IMAGENET_MEAN, IMAGENET_STD

_NORM_LUT = ((np.arange(256, dtype=np.float32)[:, None] / 255.0
              - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def normalize(img_u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 image -> normalised float32 (3, H, W)."""
    if img_u8.dtype != np.uint8 or img_u8.ndim != 3 or \
            img_u8.shape[-1] != 3:
        raise ValueError(f"want an (H, W, 3) uint8 image, got "
                         f"{img_u8.shape} {img_u8.dtype}")
    out = np.empty((3,) + img_u8.shape[:2], np.float32)
    for c in range(3):
        out[c] = _NORM_LUT[img_u8[..., c], c]
    return out
