"""DeepLabV3+ head and the full model (NCHW), the port of
mulactseg_tpu/models/deeplab.py.

Module names follow the reference torch model (classifier.project,
classifier.aspp.convs.k, classifier.aspp.project, classifier.classifier,
classifier.proxy / final) so models/convert.py maps them one to one.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from mulactseg_tpu_torch.models.layers import (
    Conv2d,
    ConvBNReLU,
    Dropout,
    FastBatchNorm,
    resize_bilinear,
)


class ASPPPooling(nn.Sequential):
    """mean -> 1x1 conv -> BN -> ReLU -> broadcast (deeplab.py:67-77);
    indices 1/2 are the reference's names aspp.convs.4.{1,2}."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.AdaptiveAvgPool2d(1),
                         Conv2d(cin, cout, 1, fan_mode="fan_in"),
                         FastBatchNorm(cout), nn.ReLU())

    def forward(self, x):
        y = super().forward(x)
        return y.expand(-1, -1, x.shape[2], x.shape[3])


class ASPP(nn.Module):
    def __init__(self, cin: int, atrous_rates: Sequence[int],
                 out_channels: int = 256, separable: bool = False):
        super().__init__()
        mods = [ConvBNReLU(cin, out_channels, 1, fan_mode="fan_in")]
        for rate in atrous_rates:
            mods.append(ConvBNReLU(cin, out_channels, 3, dilation=rate,
                                   separable=separable, fan_mode="fan_in"))
        mods.append(ASPPPooling(cin, out_channels))
        self.convs = nn.ModuleList(mods)
        self.project = nn.Sequential(
            *ConvBNReLU((len(atrous_rates) + 2) * out_channels, out_channels,
                        1, fan_mode="fan_in"),
            Dropout(0.1))

    def forward(self, x):
        return self.project(torch.cat([c(x) for c in self.convs], dim=1))


class DeepLabHeadV3Plus(nn.Module):
    """variant: 'plain' (one 3x3 block + biased final), 'c1' (two
    blocks), 'wn' (two blocks + cosine final against class proxies)."""

    def __init__(self, in_channels: int, low_level_channels: int,
                 num_classes: int, aspp_dilate: Sequence[int] = (6, 12, 18),
                 variant: str = "plain", separable: bool = False,
                 low_channels: int = 48, mid_channels: int = 256):
        super().__init__()
        if variant not in ("plain", "c1", "wn"):
            raise ValueError(f"unknown head variant {variant!r}")
        self.variant = variant
        self.project = ConvBNReLU(low_level_channels, low_channels, 1,
                                  fan_mode="fan_in")
        self.aspp = ASPP(in_channels, aspp_dilate, mid_channels, separable)
        blocks = [*ConvBNReLU(low_channels + mid_channels, mid_channels, 3,
                              separable=separable, fan_mode="fan_in")]
        if variant in ("c1", "wn"):
            blocks += [*ConvBNReLU(mid_channels, mid_channels, 3,
                                   separable=separable, fan_mode="fan_in")]
        self.classifier = nn.Sequential(*blocks)
        if variant == "wn":
            self.proxy = nn.Parameter(
                torch.empty(num_classes, mid_channels, 1, 1))
        else:
            self.final = Conv2d(mid_channels, num_classes, 1, bias=True,
                                fan_mode="fan_in")

    def forward(self, feats, return_feat: bool = False):
        low = self.project(feats["low_level"])
        y = self.aspp(feats["out"])
        y = resize_bilinear(y, low.shape[-2:])
        y = self.classifier(torch.cat([low, y], dim=1))
        if self.variant == "wn":
            # cosine logits; normalisation and the proxy product run in
            # float32 (deeplab.py:114-125). The eps sits INSIDE the sqrt.
            with torch.autocast(y.device.type, enabled=False):
                y32 = y.float()
                feat = y32 / torch.sqrt(
                    torch.sum(y32 * y32, dim=1, keepdim=True) + 1e-12)
                proxy = self.proxy.float()
                proxy_n = proxy / torch.sqrt(
                    torch.sum(proxy * proxy, dim=1, keepdim=True) + 1e-12)
                logits = torch.einsum("bchw,nc->bnhw", feat,
                                      proxy_n[:, :, 0, 0])
            point_feature = feat
        else:
            logits = self.final(y)
            point_feature = y
        if return_feat:
            return point_feature, logits
        return logits


class DeepLabV3(nn.Module):
    """Backbone + head + bilinear upsample of the logits to the input size,
    returned NCHW in float32 (the JAX package's nchw_logits hand-off,
    deeplab.py:234-240, is this layout natively)."""

    def __init__(self, backbone: nn.Module, classifier: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.classifier = classifier

    def forward(self, x, return_feat: bool = False):
        size = x.shape[-2:]
        feats = self.backbone(x)
        if return_feat:
            feat, logits = self.classifier(feats, return_feat=True)
            return (resize_bilinear(feat, size).float(),
                    resize_bilinear(logits, size).float())
        return resize_bilinear(self.classifier(feats), size).float()
