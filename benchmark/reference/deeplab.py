"""The plain reference of the DeepLabV3+ networks with the cosine
(weight-normalised) head over a ResNet, built from a configuration: plain
torch operations in float32 (the callers turn TF32 off), written from the
architecture's description.

The configuration gives the shape. `widths`: `stem` (three 3x3
convolutions when `model` names a deep stem, else one 7x7), `stage_planes`,
`blocks`, `expansion`, `aspp_channels`, `aspp_rates`,
`low_level_channels`, `decoder_channels`; `output_stride` 16 dilates stage
4, 8 stages 3 and 4, the first block of a dilated stage at the previous
dilation; `separable_conv` makes the head's 3x3 convolutions depthwise
then pointwise, or dense; `model` names the head (`deeplabv3pluswn`) and
the stem.

Module names follow the reference torch model (and so the port's), so one
dictionary of weights, made by the benchmark, loads into both by name.
Departures from the published model: BN in train mode normalises with the
biased batch variance, as the recipe's BN does; the weights are random.

`Quant`: the lower-precision control. With `fp8=True` the network
computes in float8 where the program under bf16 autocast computes in
bf16: each convolution's input, weight and output, each BN's output and
each residual sum are rounded to float8 e4m3 at a per-tensor scale (amax /
448), and the gradient of each convolution's output to float8 e5m2 (amax /
57344), the arithmetic itself in float32; the roundings pass the gradient
straight through. The cosine head, as in the program, stays float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

F8_MAX = 448.0  # float8 e4m3
F8_GRAD_MAX = 57344.0  # float8 e5m2


class Quant:
    """Whether convolutions round their operands to float8."""
    fp8 = False


def _round(x, dtype, top):
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


def _fp8(x):
    return x + (_round(x.detach(), torch.float8_e4m3fn, F8_MAX) - x.detach())


class _GradFp8(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, F8_GRAD_MAX)


class Conv(nn.Module):
    """A convolution with symmetric padding dilation * (k - 1) // 2."""

    def __init__(self, cin, cout, k, stride=1, dilation=1, groups=1,
                 head=False):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding = dilation * (k - 1) // 2
        self.head = head  # Kaiming fan_in in the head, fan_out elsewhere
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))

    def forward(self, x):
        w = self.weight
        if Quant.fp8:
            x, w = _fp8(x), _fp8(w)
        y = F.conv2d(x, w, None, self.stride, self.padding, self.dilation,
                     self.groups)
        return _fp8(_GradFp8.apply(y)) if Quant.fp8 else y


class BN(nn.Module):
    """Batch normalisation: batch statistics (biased variance) in train
    mode, the running statistics in eval mode; affine."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        if self.training:
            m = x.mean(dim=(0, 2, 3))
            v = ((x - m[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
        else:
            m, v = self.running_mean, self.running_var
        xn = (x - m[None, :, None, None]) / torch.sqrt(
            v[None, :, None, None] + 1e-5)
        y = xn * self.weight[None, :, None, None] \
            + self.bias[None, :, None, None]
        return _fp8(y) if Quant.fp8 else y


class Dropout(nn.Module):
    """Dropout whose keep mask is torch.rand(shape) >= p from `generator`
    (set by the caller, so that both sides draw the same masks)."""

    def __init__(self, p):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


class Separable(nn.Module):
    """Depthwise k x k, then pointwise 1 x 1."""

    def __init__(self, cin, cout, k, dilation):
        super().__init__()
        self.body = nn.Sequential(
            Conv(cin, cin, k, dilation=dilation, groups=cin, head=True),
            Conv(cin, cout, 1, head=True))

    def forward(self, x):
        return self.body(x)


def conv_bn_relu(cin, cout, k, dilation=1, separable=False, relu=True):
    if separable and k > 1:
        c = Separable(cin, cout, k, dilation)
    else:
        c = Conv(cin, cout, k, dilation=dilation, head=True)
    mods = [c, BN(cout)]
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, dilation, downsample=False,
                 expansion=4):
        super().__init__()
        out = planes * expansion
        self.conv1, self.bn1 = Conv(cin, planes, 1), BN(planes)
        self.conv2 = Conv(planes, planes, 3, stride, dilation)
        self.bn2 = BN(planes)
        self.conv3, self.bn3 = Conv(planes, out, 1), BN(out)
        self.downsample = (nn.Sequential(Conv(cin, out, 1, stride), BN(out))
                           if downsample else None)

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y)) + idt
        return F.relu(_fp8(y) if Quant.fp8 else y)


# the stages (2, 3, 4) whose stride becomes a dilation, by output stride
DILATED = {16: (False, False, True), 8: (False, True, True)}
HEADS = ("deeplabv3pluswn",)


def deep_stem(cfg: Dict) -> bool:
    """Whether the stem is deep, from `model`
    (`<head>_resnet<depth>[deepstem]`), whose head the reference has to
    build; the depth is `widths.blocks`."""
    head, _, backbone = cfg["model"].partition("_")
    if head not in HEADS:
        raise ValueError(f"configuration key 'model': {cfg['model']!r} "
                         f"names the head {head!r}; the reference builds "
                         f"{', '.join(HEADS)}")
    if not backbone.startswith("resnet"):
        raise ValueError(f"configuration key 'model': {cfg['model']!r} "
                         f"names the backbone {backbone!r}; the reference "
                         f"builds a ResNet")
    return backbone.endswith("deepstem")


class Backbone(nn.Module):
    """A ResNet of bottleneck blocks; the stages that `output_stride`
    dilates take dilation in place of stride, the first block of each at
    the previous dilation."""

    def __init__(self, cfg: Dict):
        super().__init__()
        w = cfg["widths"]
        deep = deep_stem(cfg)
        stem = w["stem"]
        if len(stem) != (3 if deep else 1):
            raise ValueError(f"configuration key 'widths.stem': {stem} for "
                             f"{cfg['model']!r}")
        if deep:
            self.conv1 = nn.Sequential(
                Conv(3, stem[0], 3, 2), BN(stem[0]), nn.ReLU(),
                Conv(stem[0], stem[1], 3), BN(stem[1]), nn.ReLU(),
                Conv(stem[1], stem[2], 3))
        else:
            self.conv1 = Conv(3, stem[0], 7, 2)
        self.bn1 = BN(stem[-1])
        if cfg["output_stride"] not in DILATED:
            raise ValueError(f"configuration key 'output_stride': "
                             f"{cfg['output_stride']}, not 8 or 16")
        dilated = DILATED[cfg["output_stride"]]
        exp = w["expansion"]
        cin, dilation = stem[-1], 1
        for i, (planes, n) in enumerate(zip(w["stage_planes"], w["blocks"])):
            stride, prev = (1, 2, 2, 2)[i], dilation
            if i > 0 and dilated[i - 1]:
                dilation, stride = dilation * stride, 1
            blocks = [Bottleneck(cin, planes, stride, prev,
                                 stride != 1 or cin != planes * exp, exp)]
            cin = planes * exp
            blocks += [Bottleneck(cin, planes, 1, dilation, expansion=exp)
                       for _ in range(1, n)]
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        low = self.layer1(x)
        return low, self.layer4(self.layer3(self.layer2(low)))


class Pooling(nn.Sequential):
    def __init__(self, cin, cout):
        super().__init__(nn.AdaptiveAvgPool2d(1), Conv(cin, cout, 1,
                                                       head=True),
                         BN(cout), nn.ReLU())

    def forward(self, x):
        return super().forward(x).expand(-1, -1, x.shape[2], x.shape[3])


class ASPP(nn.Module):
    def __init__(self, cin, rates, cout, separable):
        super().__init__()
        self.convs = nn.ModuleList(
            [conv_bn_relu(cin, cout, 1)]
            + [conv_bn_relu(cin, cout, 3, r, separable=separable)
               for r in rates]
            + [Pooling(cin, cout)])
        self.project = nn.Sequential(
            *conv_bn_relu((len(rates) + 2) * cout, cout, 1), Dropout(0.1))

    def forward(self, x):
        return self.project(torch.cat([c(x) for c in self.convs], dim=1))


class Head(nn.Module):
    """The V3+ decoder with the cosine head: the low-level projection,
    ASPP, two 3x3 blocks, logits against normalised class proxies."""

    def __init__(self, cfg: Dict):
        super().__init__()
        w, sep = cfg["widths"], cfg["separable_conv"]
        exp, planes = w["expansion"], w["stage_planes"]
        low, mid = w["low_level_channels"], w["decoder_channels"]
        self.project = conv_bn_relu(planes[0] * exp, low, 1)
        self.aspp = ASPP(planes[-1] * exp, w["aspp_rates"],
                         w["aspp_channels"], sep)
        self.classifier = nn.Sequential(
            *conv_bn_relu(low + w["aspp_channels"], mid, 3, separable=sep),
            *conv_bn_relu(mid, mid, 3, separable=sep))
        self.proxy = nn.Parameter(torch.empty(cfg["num_outputs"], mid, 1, 1))

    def forward(self, low, out):
        low = self.project(low)
        y = F.interpolate(self.aspp(out), size=low.shape[-2:],
                          mode="bilinear", align_corners=False)
        y = self.classifier(torch.cat([low, y], dim=1))
        feat = y / torch.sqrt((y * y).sum(1, keepdim=True) + 1e-12)
        p = self.proxy[:, :, 0, 0]
        p = p / torch.sqrt((p * p).sum(1, keepdim=True) + 1e-12)
        return feat, torch.einsum("bchw,nc->bnhw", feat, p)


class Net(nn.Module):
    """forward(x) -> logits (B, N, H, W) at the input size; with
    return_feat, (features, logits), both upsampled."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.backbone = Backbone(cfg)
        self.classifier = Head(cfg)

    def forward(self, x, return_feat=False):
        size = x.shape[-2:]
        feat, logits = self.classifier(*self.backbone(x))
        up = lambda t: F.interpolate(t, size=size, mode="bilinear",  # noqa
                                     align_corners=False)
        if return_feat:
            return up(feat), up(logits)
        return up(logits)


def weight_rule(net: nn.Module, cfg: Dict
                ) -> Tuple[List[Tuple[str, float]], Dict[str, float]]:
    """The leaves drawn from the seed, in draw order, each with its
    standard deviation: Kaiming-normal convolutions (fan_out in the
    backbone, fan_in in the head) and class proxies (fan_in). The fill of
    every other leaf: BN scale 1 (the last BN of each residual block at
    init['residual_bn_scale']), bias 0, running mean 0 and variance 1."""
    convs = {f"{n}.weight": m for n, m in net.named_modules()
             if isinstance(m, Conv)}
    drawn = []
    for n, p in net.named_parameters():
        if n in convs or n.endswith("proxy"):
            o, i, kh, kw = p.shape
            head = n.endswith("proxy") or convs[n].head
            drawn.append((n, math.sqrt(2.0 / ((i if head else o) * kh * kw))))
    res = float(cfg.get("init", {}).get("residual_bn_scale", 1.0))
    picked = {n for n, _ in drawn}
    fill = {n: 0.0 if n.endswith("bias") else (res if ".bn3." in n else 1.0)
            for n, _ in net.named_parameters() if n not in picked}
    fill.update({n: 1.0 if n.endswith("running_var") else 0.0
                 for n, _ in net.named_buffers()})
    return drawn, fill


def dropouts(net: nn.Module):
    return [m for m in net.modules() if isinstance(m, Dropout)]
