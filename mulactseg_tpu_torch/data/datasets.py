"""File-backed datasets of the PyTorch port (mirrors
mulactseg_tpu/data/datasets.py). So far the stage-2 loader only; the
recipe's other loaders are ROADMAP.md queue A, item 10.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from mulactseg_tpu_torch.data.transforms import normalize
from mulactseg_tpu_torch.utils.png import read_gray8, read_rgb8


class RegionDatasetPlbl:
    """Stage-2 loader (region_cityscapes_plbl.py:18-48): each labelled
    image with its saved pseudo-label PNG, <plbl_dir>/<label id>.png, as
    the dense training target. Images are read with read_rgb8 and
    normalised to float32 (3, H, W); the recipe's transform
    (rescale_769_nospx) is not ported yet (ROADMAP.md queue A, item 10)."""

    def __init__(self, cfg, im_idx: List[List[str]], plbl_dir: str):
        self.cfg = cfg
        self.im_idx = list(im_idx)
        self.plbl_dir = plbl_dir
        self.suppix: Dict[str, List[int]] = {}

    def __len__(self):
        return len(self.im_idx)

    def __getitem__(self, index: int) -> Dict:
        img_p, lbl_p, _ = self.im_idx[index]
        lbl_id = os.path.basename(lbl_p).split(".")[0]
        plbl = read_gray8(os.path.join(self.plbl_dir, f"{lbl_id}.png"))
        return {"images": normalize(read_rgb8(img_p)),
                "labels": plbl.astype(np.int32),
                "fnames": self.im_idx[index]}
