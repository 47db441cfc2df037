"""The plain reference of the recipe's network, DeepLabV3+ with the cosine
(weight-normalised) head over a deep-stem ResNet-50 at output stride 16,
separable convolutions in the head: plain torch operations in float32
(the callers turn TF32 off), written from the architecture's description.

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
    def __init__(self, cin, planes, stride, dilation, downsample=False):
        super().__init__()
        out = planes * 4
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


class Backbone(nn.Module):
    """ResNet-50 with the deep stem; layer 4 dilated (output stride 16),
    its first block at the previous dilation."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Sequential(Conv(3, 64, 3, 2), BN(64), nn.ReLU(),
                                   Conv(64, 64, 3), BN(64), nn.ReLU(),
                                   Conv(64, 128, 3))
        self.bn1 = BN(128)
        cin, dilation = 128, 1
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                            (3, 4, 6, 3))):
            stride, prev = (1, 2, 2, 2)[i], dilation
            if i == 3:
                dilation, stride = dilation * stride, 1
            blocks = [Bottleneck(cin, planes, stride, prev,
                                 stride != 1 or cin != planes * 4)]
            cin = planes * 4
            blocks += [Bottleneck(cin, planes, 1, dilation)
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
    def __init__(self, cin, rates=(6, 12, 18), cout=256):
        super().__init__()
        self.convs = nn.ModuleList(
            [conv_bn_relu(cin, cout, 1)]
            + [conv_bn_relu(cin, cout, 3, r, separable=True) for r in rates]
            + [Pooling(cin, cout)])
        self.project = nn.Sequential(*conv_bn_relu(5 * cout, cout, 1),
                                     Dropout(0.1))

    def forward(self, x):
        return self.project(torch.cat([c(x) for c in self.convs], dim=1))


class Head(nn.Module):
    def __init__(self, num_outputs):
        super().__init__()
        self.project = conv_bn_relu(256, 48, 1)
        self.aspp = ASPP(2048)
        self.classifier = nn.Sequential(
            *conv_bn_relu(304, 256, 3, separable=True),
            *conv_bn_relu(256, 256, 3, separable=True))
        self.proxy = nn.Parameter(torch.empty(num_outputs, 256, 1, 1))

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

    def __init__(self, num_outputs):
        super().__init__()
        self.backbone = Backbone()
        self.classifier = Head(num_outputs)

    def forward(self, x, return_feat=False):
        size = x.shape[-2:]
        feat, logits = self.classifier(*self.backbone(x))
        up = lambda t: F.interpolate(t, size=size, mode="bilinear",  # noqa
                                     align_corners=False)
        if return_feat:
            return up(feat), up(logits)
        return up(logits)


def dropouts(net: nn.Module):
    return [m for m in net.modules() if isinstance(m, Dropout)]
