"""MobileNetV2 backbone with output-stride dilation (NCHW), the port of
mulactseg_tpu/models/mobilenet.py.

Module names follow the reference torch model (backbone/mobilenetv2.py
split as modeling.py:56-63 splits it): `low_level_features` is features
0-3 (the stem and blocks 0-2, 24 channels at stride 4) and
`high_level_features` features 4-17 (blocks 3-16, 320 channels); each
block's `conv` is the reference's Sequential (`conv.0` the 1x1 expansion
ConvBNReLU where t != 1, then the depthwise ConvBNReLU, the 1x1
projection and its BN).
"""

from __future__ import annotations

import torch.nn as nn

from mulactseg_tpu_torch.models.layers import Conv2d, FastBatchNorm

# t (expansion), c (out channels), n (blocks), s (first block's stride)
_SETTINGS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
LOW_LEVEL_BLOCKS = 3  # the low-level tap follows block 2 (features[0:4])


def _conv_bn_relu6(cin: int, cout: int, kernel: int, stride: int = 1,
                   dilation: int = 1, groups: int = 1) -> nn.Sequential:
    return nn.Sequential(
        Conv2d(cin, cout, kernel, stride, dilation, groups=groups),
        FastBatchNorm(cout), nn.ReLU6())


class InvertedResidual(nn.Module):
    """1x1 expansion (t != 1), 3x3 depthwise at `dilation`, 1x1
    projection; the residual where the stride is 1 and the width kept."""

    def __init__(self, cin: int, cout: int, stride: int, expand: int,
                 dilation: int = 1):
        super().__init__()
        hidden = cin * expand
        self.use_res = stride == 1 and cin == cout
        layers = [_conv_bn_relu6(cin, hidden, 1)] if expand != 1 else []
        layers += [_conv_bn_relu6(hidden, hidden, 3, stride, dilation,
                                  groups=hidden),
                   Conv2d(hidden, cout, 1), FastBatchNorm(cout)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.use_res else y


class MobileNetV2(nn.Module):
    """Returns {'low_level': 24 channels at stride 4, 'out': 320
    channels}. Once the stride reached `output_stride`, a block's stride
    turns into dilation for the blocks after it (mobilenet.py:64-74)."""

    def __init__(self, output_stride: int = 16):
        super().__init__()
        blocks = []
        cin, current_stride, dilation = 32, 2, 1
        for t, c, n, s in _SETTINGS:
            for i in range(n):
                stride = s if i == 0 else 1
                d = dilation
                if stride > 1 and current_stride >= output_stride:
                    dilation *= stride
                    stride = 1
                else:
                    current_stride *= stride
                blocks.append(InvertedResidual(cin, c, stride, t, d))
                cin = c
        self.low_level_features = nn.Sequential(
            _conv_bn_relu6(3, 32, 3, 2), *blocks[:LOW_LEVEL_BLOCKS])
        self.high_level_features = nn.Sequential(*blocks[LOW_LEVEL_BLOCKS:])

    def forward(self, x):
        low = self.low_level_features(x)
        return {"low_level": low, "out": self.high_level_features(low)}


def mobilenet_v2(output_stride: int = 16) -> MobileNetV2:
    return MobileNetV2(output_stride=output_stride)
