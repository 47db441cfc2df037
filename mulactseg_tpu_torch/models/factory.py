"""Model factory, the port of mulactseg_tpu/models/factory.py: OS8 dilates
layers 3+4 with ASPP rates (12, 24, 36); OS16 dilates layer 4 with
(6, 12, 18)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from mulactseg_tpu_torch.device import resolve_device
from mulactseg_tpu_torch.models import resnet as _resnet
from mulactseg_tpu_torch.models.deeplab import DeepLabHeadV3Plus, DeepLabV3
from mulactseg_tpu_torch.models.layers import Conv2d, kaiming_std

MODEL_NAMES = (
    "deeplabv3_resnet50", "deeplabv3plus_resnet50", "deeplabv3plusc1_resnet50",
    "deeplabv3_resnet101", "deeplabv3plus_resnet101", "deeplabv3_mobilenet",
    "deeplabv3plus_mobilenet", "deeplabv3pluswn_resnet50deepstem",
    "deeplabv2_resnet101", "deeplabv2_mobilenet",
    "deeplabv3pluswn_resnet101deepstem", "deeplabv3pluswn_resnet50",
    "deeplabv3plus_resnet50deepstem", "deeplabv3plus_resnet101deepstem",
)
_HEAD_VARIANT = {"deeplabv3plus": "plain", "deeplabv3plusc1": "c1",
                 "deeplabv3pluswn": "wn"}


def _dilation_cfg(output_stride: int):
    if output_stride == 8:
        return (False, True, True), (12, 24, 36)
    return (False, False, True), (6, 12, 18)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Kaiming-normal convolutions (fan_out in the backbone, fan_in in the
    heads, as the JAX package's inits) and proxies, drawn from
    `generator`; BN keeps scale 1 / bias 0 / mean 0 / var 1."""
    for m in model.modules():
        if isinstance(m, Conv2d):
            w = torch.empty(m.weight.shape)
            w.normal_(0.0, kaiming_std(w, m.fan_mode), generator=generator)
            m.weight.copy_(w)
        elif isinstance(m, DeepLabHeadV3Plus) and m.variant == "wn":
            w = torch.empty(m.proxy.shape)
            w.normal_(0.0, kaiming_std(w, "fan_in"), generator=generator)
            m.proxy.copy_(w)


def get_model(model: str, num_classes: int, output_stride: int = 16,
              separable_conv: bool = False, device="cuda",
              generator: Optional[torch.Generator] = None) -> DeepLabV3:
    """Build a DeepLabV3+ over a ResNet backbone on `device` with weights
    drawn from `generator` (a CPU torch.Generator; seed 0 when None).
    Parameters are float32; logits come back float32 NCHW."""
    if model not in MODEL_NAMES:
        raise ValueError(f"unknown model {model!r}")
    arch, backbone_name = model.split("_", 1)
    if arch not in _HEAD_VARIANT or backbone_name == "mobilenet":
        raise NotImplementedError(
            f"{model!r} is not ported yet: the port covers the DeepLabV3+ "
            "ResNet models; the rest of the zoo is ROADMAP.md queue A, "
            "item 16")
    dev = resolve_device(device)
    rswd, aspp = _dilation_cfg(output_stride)
    backbone = getattr(_resnet, backbone_name)(
        replace_stride_with_dilation=rswd)
    head = DeepLabHeadV3Plus(2048, 256, num_classes, aspp,
                             variant=_HEAD_VARIANT[arch],
                             separable=separable_conv)
    net = DeepLabV3(backbone, head)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(net, generator)
    return net.to(dev)
