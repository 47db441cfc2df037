"""Dataset constants, the port's copy of mulactseg_tpu/data/constants.py:
the ImageNet normalisation (:35-36), the Cityscapes label id -> train id
table that encode_cityscapes reads (:12-20), and the PASCAL VOC class
names and palette (:38-60), which the VOC label PNGs index."""

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

VOC_CLASSES = (
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def voc_cmap(N: int = 256) -> np.ndarray:
    """The standard VOC palette, (N, 3) uint8: entry i spreads the bits of
    i over the high bits of R, G and B, three at a time."""
    i = np.arange(N)
    cmap = np.zeros((N, 3), np.int64)
    for j in range(8):
        for ch in range(3):
            cmap[:, ch] |= ((i >> (3 * j + ch)) & 1) << (7 - j)
    return cmap.astype(np.uint8)
