"""DeepLabV3+, DeepLabV3 and DeepLabV2 heads and the full model (NCHW),
the port of mulactseg_tpu/models/deeplab.py.

Module names follow the reference torch model (classifier.project,
classifier.aspp.convs.k, classifier.aspp.project, classifier.classifier,
classifier.proxy / final) so models/convert.py maps them one to one. The
DeepLabV3 head reuses the V3+ head's names for its ASPP, its 3x3 block
and its final 1x1; the DeepLabV2 head's four classifiers are the
reference's classifier.conv2d_list.k (deeplabv2.py), and the auxiliary
head is aux_classifier.classifier.
"""

from __future__ import annotations

from typing import Optional, Sequence

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


def cosine_logits(y, proxy):
    """The weight-normalised (cosine) head: (features, logits) of y (B, C,
    H, W) against class proxies (N, C, 1, 1), the features L2-normalised
    over C and the logits their product with the normalised proxies, both
    in float32 whatever the autocast (deeplab.py:114-125). The eps sits
    INSIDE the sqrt."""
    with torch.autocast(y.device.type, enabled=False):
        y32 = y.float()
        feat = y32 / torch.sqrt(
            torch.sum(y32 * y32, dim=1, keepdim=True) + 1e-12)
        proxy = proxy.float()
        proxy_n = proxy / torch.sqrt(
            torch.sum(proxy * proxy, dim=1, keepdim=True) + 1e-12)
        logits = torch.einsum("bchw,nc->bnhw", feat, proxy_n[:, :, 0, 0])
    return feat, logits


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
            point_feature, logits = cosine_logits(y, self.proxy)
        else:
            logits = self.final(y)
            point_feature = y
        if return_feat:
            return point_feature, logits
        return logits


class DeepLabHeadV3(nn.Module):
    """ASPP, one 3x3 ConvBNReLU, a biased 1x1 final (deeplab.py:135-150);
    return_feat hands out the 3x3 block's output."""

    def __init__(self, in_channels: int, num_classes: int,
                 aspp_dilate: Sequence[int] = (6, 12, 18),
                 separable: bool = False):
        super().__init__()
        self.aspp = ASPP(in_channels, aspp_dilate, 256, separable)
        self.classifier = ConvBNReLU(256, 256, 3, separable=separable,
                                     fan_mode="fan_in")
        self.final = Conv2d(256, num_classes, 1, bias=True,
                            fan_mode="fan_in")

    def forward(self, feats, return_feat: bool = False):
        y = self.classifier(self.aspp(feats["out"]))
        logits = self.final(y)
        if return_feat:
            return y, logits
        return logits


class DeepLabHeadV2(nn.Module):
    """The sum of four biased, dilated 3x3 classifiers over the backbone's
    output, no BN (deeplab.py:153-170); return_feat hands out that
    output."""

    def __init__(self, in_channels: int, num_classes: int,
                 dilations: Sequence[int] = (6, 12, 18, 24)):
        super().__init__()
        self.conv2d_list = nn.ModuleList(
            Conv2d(in_channels, num_classes, 3, dilation=d, bias=True,
                   fan_mode="fan_in") for d in dilations)

    def forward(self, feats, return_feat: bool = False):
        x = feats["out"]
        logits = self.conv2d_list[0](x)
        for conv in self.conv2d_list[1:]:
            logits = logits + conv(x)
        if return_feat:
            return x, logits
        return logits


class SimpleAuxHead(nn.Module):
    """One bias-free 3x3 convolution (deeplab.py:173-184), attached as
    DeepLabV3's aux_classifier over the low-level features."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.classifier = Conv2d(in_channels, channels, 3, fan_mode="fan_in")

    def forward(self, x):
        return self.classifier(x)


class DeepLabV3(nn.Module):
    """Backbone + head + bilinear upsample of the logits to the input size,
    returned NCHW in float32 (the JAX package's nchw_logits hand-off,
    deeplab.py:234-240, is this layout natively). aux_classifier, when
    given, reads the backbone's low-level features and return_aux hands
    back (logits, aux) (deeplab.py:187-213)."""

    def __init__(self, backbone: nn.Module, classifier: nn.Module,
                 aux_classifier: Optional[nn.Module] = None):
        super().__init__()
        self.backbone = backbone
        self.classifier = classifier
        self.aux_classifier = aux_classifier

    def forward(self, x, return_feat: bool = False, feat_bf16: bool = False,
                return_aux: bool = False):
        """feat_bf16 (with return_feat): the features are cast to bfloat16
        at head resolution, before the upsample, and come back bfloat16
        (the pseudo-labeller's hand-off when the network runs in bfloat16,
        JAX deeplab.py:221-228)."""
        size = x.shape[-2:]
        feats = self.backbone(x)
        if return_aux:
            if self.aux_classifier is None:
                raise ValueError("model built without aux_classifier")
            aux = resize_bilinear(self.aux_classifier(feats["low_level"]),
                                  size).float()
            return resize_bilinear(self.classifier(feats), size).float(), aux
        if return_feat:
            feat, logits = self.classifier(feats, return_feat=True)
            if feat_bf16:
                feat = resize_bilinear(feat.to(torch.bfloat16), size)
            else:
                feat = resize_bilinear(feat, size).float()
            return feat, resize_bilinear(logits, size).float()
        return resize_bilinear(self.classifier(feats), size).float()
