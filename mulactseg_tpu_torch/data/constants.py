"""ImageNet normalisation constants (the port's copy of
mulactseg_tpu/data/constants.py:35-36)."""

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
