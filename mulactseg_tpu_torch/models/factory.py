"""Model factory, the port of mulactseg_tpu/models/factory.py: OS8 dilates
layers 3+4 with ASPP rates (12, 24, 36); OS16 dilates layer 4 with
(6, 12, 18). MobileNetV2 takes the same rates (factory.py:49-53);
separable convolutions apply to the V3+ heads only.

MODEL_NAMES are the networks held to the JAX package's; PORT_NAMES are
the port's alone, held to the benchmark's plain reference
(benchmark/reference/): SegFormer-B5 with the cosine head
(models/segformer.py), at its only output stride, 32."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from mulactseg_tpu_torch.device import resolve_device
from mulactseg_tpu_torch.models import resnet as _resnet
from mulactseg_tpu_torch.models import segformer as _segformer
from mulactseg_tpu_torch.models.deeplab import (
    DeepLabHeadV2,
    DeepLabHeadV3,
    DeepLabHeadV3Plus,
    DeepLabV3,
)
from mulactseg_tpu_torch.models.layers import Conv2d, kaiming_std
from mulactseg_tpu_torch.models.mobilenet import mobilenet_v2

MODEL_NAMES = (
    "deeplabv3_resnet50", "deeplabv3plus_resnet50", "deeplabv3plusc1_resnet50",
    "deeplabv3_resnet101", "deeplabv3plus_resnet101", "deeplabv3_mobilenet",
    "deeplabv3plus_mobilenet", "deeplabv3pluswn_resnet50deepstem",
    "deeplabv2_resnet101", "deeplabv2_mobilenet",
    "deeplabv3pluswn_resnet101deepstem", "deeplabv3pluswn_resnet50",
    "deeplabv3plus_resnet50deepstem", "deeplabv3plus_resnet101deepstem",
)
PORT_NAMES = ("segformerwn_mitb5",)
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
    """Build one of MODEL_NAMES or PORT_NAMES on `device` with weights
    drawn from `generator` (a CPU torch.Generator; seed 0 when None).
    Parameters are float32; logits come back float32 NCHW."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if model in PORT_NAMES:
        if output_stride != 32:
            raise ValueError(f"{model} has output stride 32 only, not "
                             f"{output_stride}")
        net = _segformer.segformer(num_classes)
        _segformer.init_weights(net, generator)
        return net.to(resolve_device(device))
    if model not in MODEL_NAMES:
        raise ValueError(f"unknown model {model!r}")
    arch, backbone_name = model.split("_", 1)
    dev = resolve_device(device)
    rswd, aspp = _dilation_cfg(output_stride)
    if backbone_name == "mobilenet":
        backbone, cin, low = mobilenet_v2(output_stride), 320, 24
    else:
        backbone = getattr(_resnet, backbone_name)(
            replace_stride_with_dilation=rswd)
        cin, low = 2048, 256
    if arch in _HEAD_VARIANT:
        head = DeepLabHeadV3Plus(cin, low, num_classes, aspp,
                                 variant=_HEAD_VARIANT[arch],
                                 separable=separable_conv)
    elif arch == "deeplabv3":
        head = DeepLabHeadV3(cin, num_classes, aspp)
    else:
        head = DeepLabHeadV2(cin, num_classes)
    net = DeepLabV3(backbone, head)
    init_weights(net, generator)
    return net.to(dev)
