"""Dataset constants, the port's copy of mulactseg_tpu/data/constants.py:
the ImageNet normalisation (:35-36), the Cityscapes label id -> train id
table that encode_cityscapes reads (:12-20), the Cityscapes class names
and train id colours with decode_cityscapes (:20-33, 63-65), which the
visualisations read, the SYNTHIA label id -> Cityscapes train id table of
encode_synthia (:68-73), and the PASCAL VOC class names and palette
(:38-60), which the VOC label PNGs index."""

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

CITYSCAPES_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
)

# train id -> RGB; row 19 (black) is the colour of ignore and of the
# extra class of a 19-class model
TRAIN_ID_TO_COLOR = np.asarray([
    (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
    (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
    (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
    (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 80, 100),
    (0, 0, 230), (119, 11, 32), (0, 0, 0),
], dtype=np.uint8)


def decode_cityscapes(train_ids: np.ndarray) -> np.ndarray:
    """(H, W) train ids (255 = ignore) -> (H, W, 3) uint8 colours."""
    t = np.where(train_ids == 255, 19, train_ids)
    return TRAIN_ID_TO_COLOR[t]


# SYNTHIA raw id -> Cityscapes train id (255 = ignore), indexed by the
# SYNTHIA label id (the reference's dataloader/constant.py:88-90)
SYN_ID_TO_TRAIN_ID = np.array(
    [255, 10, 2, 0, 1, 4, 8, 5, 13, 7, 11, 18, 17,
     255, 255, 6, 9, 12, 14, 15, 16, 3, 255, 255, 255,
     255, 255, 255, 255, 255, 255, 255, 255, 255, 255], dtype=np.uint8)

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
