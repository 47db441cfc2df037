"""Shared building blocks (NCHW), the port of mulactseg_tpu/models/layers.py.

Parameter names follow the reference torch model (conv `weight`, BN
`weight/bias/running_mean/running_var`), so models/convert.py and the JAX
package's models/torch_import.py both read them.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Module):
    """Convolution with explicit symmetric padding dilation*(k-1)//2
    (layers.py:27). `fan_mode` records the Kaiming mode of the JAX init:
    'fan_out' for the backbone, 'fan_in' for the heads (layers.py:20-21).
    Weights are left uninitialised; models/factory.init_weights fills
    them from an explicit generator."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, bias: bool = False,
                 fan_mode: str = "fan_out"):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding = dilation * (kernel - 1) // 2
        self.fan_mode = fan_mode
        self.weight = nn.Parameter(
            torch.empty(cout, cin // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups)


class FastBatchNorm(nn.Module):
    """BatchNorm with the JAX package's FastBatchNorm semantics
    (layers.py:43-96): the BIASED single-pass variance max(E[x^2]-m^2, 0)
    normalises AND feeds the running update (nn.BatchNorm2d would store
    the unbiased one), running = 0.9*running + 0.1*batch (flax momentum
    0.9 == torch momentum 0.1), and the affine folds into one multiply-add
    y = x*a + b in the input dtype with a, b computed in float32.

    `frozen` (set by bn_frozen) makes a train-mode forward use and keep
    the running statistics."""

    def __init__(self, channels: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.frozen = False
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if self.training and not self.frozen:
            n = x.numel() // x.shape[1]
            xf = x.float()
            m = xf.sum(dim=(0, 2, 3)) / n
            v = torch.clamp((xf * xf).sum(dim=(0, 2, 3)) / n - m * m, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(
                    self.momentum * m.detach())
                self.running_var.mul_(1.0 - self.momentum).add_(
                    self.momentum * v.detach())
        else:
            m, v = self.running_mean, self.running_var
        a = self.weight * torch.rsqrt(v + self.eps)
        b = self.bias - m * a
        dt = x.dtype
        return x * a.to(dt)[None, :, None, None] + b.to(dt)[None, :, None, None]


@contextlib.contextmanager
def bn_frozen(model: nn.Module, flag: bool):
    """Freeze BN during a train-mode forward (reference freeze_bn(): only
    the BN modules go to eval mode, dropout stays live; layers.py:102-117).
    Scoped to `model` rather than a process-wide flag."""
    bns = [m for m in model.modules() if isinstance(m, FastBatchNorm)]
    prev = [m.frozen for m in bns]
    for m in bns:
        m.frozen = bool(flag)
    try:
        yield
    finally:
        for m, p in zip(bns, prev):
            m.frozen = p


class Dropout(nn.Module):
    """Dropout whose mask comes from an explicit torch.Generator
    (`generator`, set by the train step; None draws from torch's default
    generator). Identity in eval mode or at p == 0."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


class SeparableConv(nn.Module):
    """Depthwise + pointwise pair (reference AtrousSeparableConvolution,
    deeplabv3.py:168-192; layers.py:141-147). `body.0` / `body.1` are the
    reference's parameter names."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dilation: int = 1, fan_mode: str = "fan_out"):
        super().__init__()
        self.body = nn.Sequential(
            Conv2d(cin, cin, kernel, stride, dilation, groups=cin,
                   fan_mode=fan_mode),
            Conv2d(cin, cout, 1, fan_mode=fan_mode))

    def forward(self, x):
        return self.body(x)


class ConvBNReLU(nn.Sequential):
    """[conv | separable conv, BN, ReLU?] — indices 0/1 match the
    reference's nn.Sequential names (layers.py:129-154)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, relu: bool = True,
                 separable: bool = False, fan_mode: str = "fan_out"):
        if separable and kernel > 1:
            c = SeparableConv(cin, cout, kernel, stride, dilation, fan_mode)
        else:
            c = Conv2d(cin, cout, kernel, stride, dilation, fan_mode=fan_mode)
        mods = [c, FastBatchNorm(cout)]
        if relu:
            mods.append(nn.ReLU())
        super().__init__(*mods)


def resize_bilinear(x, size):
    """F.interpolate bilinear with half-pixel centres and no antialias
    (layers.py:196-212)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False)


def kaiming_std(weight: torch.Tensor, fan_mode: str) -> float:
    """Std of the JAX package's variance_scaling(2.0, mode, 'normal') for
    an OIHW weight (fan_in = I*kh*kw, fan_out = O*kh*kw)."""
    o, i, kh, kw = weight.shape
    fan = (i if fan_mode == "fan_in" else o) * kh * kw
    return math.sqrt(2.0 / fan)
