"""Dataset constants, the port's copy of mulactseg_tpu/data/constants.py:
the ImageNet normalisation (:35-36) and the Cityscapes label id -> train
id table that encode_cityscapes reads (:12-20)."""

import numpy as np

# Cityscapes label id -> train id (255 = ignore), the standard
# cityscapesscripts table
_CITYSCAPES_ID_TO_TRAIN = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}

ID_TO_TRAIN_ID = np.full(256, 255, dtype=np.uint8)
for _k, _v in _CITYSCAPES_ID_TO_TRAIN.items():
    ID_TO_TRAIN_ID[_k] = _v

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
