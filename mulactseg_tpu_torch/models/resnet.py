"""ResNet backbones with deep stem and output-stride dilation, the port of
mulactseg_tpu/models/resnet.py.

The JAX package's space-to-batch rewrite of dilated stages and its
space-to-depth stem are exact TPU rewrites of plain dilated / strided
convolutions; here the plain convolutions run directly.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch.nn as nn

from mulactseg_tpu_torch.models.layers import Conv2d, FastBatchNorm


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1)
        self.bn1 = FastBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, dilation)
        self.bn2 = FastBatchNorm(planes)
        self.conv3 = Conv2d(planes, out, 1)
        self.bn3 = FastBatchNorm(out)
        self.relu = nn.ReLU()
        self.downsample = (nn.Sequential(Conv2d(inplanes, out, 1, stride),
                                         FastBatchNorm(out))
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + identity)


class ResNet(nn.Module):
    """layers: blocks per stage, e.g. (3, 4, 6, 3) for ResNet-50.
    Returns {'low_level': layer1 output, 'out': layer4 output}."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 deep_stem: bool = False, stem_width: int = 64,
                 replace_stride_with_dilation: Tuple[bool, bool, bool] = (
                     False, False, True),
                 stage_planes: Tuple[int, int, int, int] = (64, 128, 256, 512)):
        super().__init__()
        if deep_stem:
            # reference names conv1.{0,3,6} convs and conv1.{1,4} BNs
            # (torch_import.py:9-10)
            self.conv1 = nn.Sequential(
                Conv2d(3, stem_width, 3, 2), FastBatchNorm(stem_width),
                nn.ReLU(),
                Conv2d(stem_width, stem_width, 3), FastBatchNorm(stem_width),
                nn.ReLU(),
                Conv2d(stem_width, stem_width * 2, 3))
            inplanes = stem_width * 2
        else:
            self.conv1 = Conv2d(3, 64, 7, 2)
            inplanes = 64
        self.bn1 = FastBatchNorm(inplanes)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)

        dilation = 1
        for stage in range(4):
            planes = stage_planes[stage]
            stride = (1, 2, 2, 2)[stage]
            prev_dilation = dilation
            if stage > 0 and replace_stride_with_dilation[stage - 1]:
                dilation *= stride
                stride = 1
            # the first block of a dilated stage keeps the PREVIOUS
            # dilation (the torch quirk, resnet.py:135-145)
            blocks = [Bottleneck(inplanes, planes, stride, prev_dilation,
                                 downsample=(stride != 1
                                             or inplanes != planes * 4))]
            inplanes = planes * 4
            blocks += [Bottleneck(inplanes, planes, 1, dilation)
                       for _ in range(1, layers[stage])]
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        low = self.layer1(x)
        out = self.layer4(self.layer3(self.layer2(low)))
        return {"low_level": low, "out": out}


def resnet50(**kw):
    return ResNet(layers=(3, 4, 6, 3), deep_stem=False, **kw)


def resnet101(**kw):
    return ResNet(layers=(3, 4, 23, 3), deep_stem=False, **kw)


def resnet50deepstem(**kw):
    return ResNet(layers=(3, 4, 6, 3), deep_stem=True, stem_width=64, **kw)


def resnet101deepstem(**kw):
    return ResNet(layers=(3, 4, 23, 3), deep_stem=True, stem_width=64, **kw)
