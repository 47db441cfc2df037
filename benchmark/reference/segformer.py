"""The plain reference of SegFormer (Xie et al., NeurIPS 2021,
arXiv:2105.15203) with the cosine (weight-normalised) head, built from a
configuration: plain torch operations in float32 (the callers turn TF32
off), written from NVlabs/SegFormer's mix_transformer.py (class mit_b5)
and segformer_head.py.

The configuration gives the shape. `widths`: `embed_dims`, `depths`,
`num_heads`, `sr_ratios`, `mlp_ratio`, `patch_sizes`, `strides`,
`decoder_channels`, `drop_path`; `num_outputs` the classes of the head;
`output_stride` must be the product of the strides; `model` names the
cosine head (`segformerwn_...`).

The network: four stages, each an overlapping patch embedding (a k x k
convolution of stride s, padding k // 2, with bias, then LayerNorm eps
1e-5), blocks and a LayerNorm (eps 1e-6). A block is x + drop_path(
attn(norm1(x))), then x + drop_path(mlp(norm2(x))), LayerNorms at eps
1e-6. attn: q from every token, k and v from the tokens through a sr x sr
convolution of stride sr and a LayerNorm (eps 1e-5) where sr > 1,
softmax(q k^T / sqrt(d)) v over heads of width d, a projection. mlp:
Linear, depthwise 3x3, GELU (erf), Linear. Drop-path rates rise linearly
from 0 to `drop_path` over all blocks. The decoder: each stage through a
Linear to `decoder_channels`, resized bilinearly (half-pixel centres) to
stride 4, concatenated c4, c3, c2, c1, a 1x1 convolution without bias,
BN, ReLU, channel-wise dropout at 0.1.

Module names and order are the port's (models/segformer.py), so one
dictionary of weights loads into both by name. Departures from the
published model:
- the cosine head (features and class proxies L2-normalised, in float32)
  in place of `linear_pred`, MulActSeg's head on SegFormer's decoder;
- BN in train mode normalises with the biased batch variance, as the
  recipe's BN does;
- the weights are random: plain normals where NVlabs draws
  trunc_normal_(std=0.02) (its bounds of +-2 lie 100 sigma out);
- a dropout keeps where torch.rand(...) >= p from the caller's
  generator, the law of timm's floor(1 - p + rand);
- on a card each block is checkpointed (torch.utils.checkpoint): the
  same arithmetic, recomputed in the backward pass; its drop-path masks
  are drawn before the block, in the order the port draws them.

`Quant`: the lower-precision control (shared with deeplab.py). With
`fp8=True` every Linear's and convolution's input, weight and output, the
attention's q, k, v, scores, probabilities and output, and each
LayerNorm's and BN's output are rounded to float8 e4m3 at a per-tensor
scale (amax / 448), and the gradient of each Linear's and convolution's
output to float8 e5m2 (amax / 57344), the arithmetic itself in float32;
the roundings pass the gradient straight through. The cosine head stays
float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.deeplab import BN, Quant, _fp8, _GradFp8

def _q(x):
    return _fp8(x) if Quant.fp8 else x


def _out(y):
    """An output of a Linear or convolution: e4m3, its gradient e5m2."""
    return _fp8(_GradFp8.apply(y)) if Quant.fp8 else y


class Linear(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return _out(_q(x) @ _q(self.weight).t() + self.bias)


class Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, groups=1,
                 bias=True):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return _out(F.conv2d(_q(x), _q(self.weight), self.bias, self.stride,
                             self.padding, 1, self.groups))


class LayerNorm(nn.Module):
    """Over the last axis, biased variance, affine."""

    def __init__(self, c, eps):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        m = x.mean(-1, keepdim=True)
        v = ((x - m) ** 2).mean(-1, keepdim=True)
        return _q((x - m) / torch.sqrt(v + self.eps) * self.weight
                  + self.bias)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


class Dropout(nn.Module):
    """Dropout whose keep mask is torch.rand(mask shape) >= p from
    `generator` (set by the caller, so that both sides draw the same
    masks), kept entries scaled by 1 / (1 - p); no draw at p == 0 or in
    eval mode. The mask shape is `per_row` after the batch axis: an
    element (dropout), a sample (drop-path: (1, 1)) or a channel
    (Dropout2d: (C, 1, 1))."""

    def __init__(self, p):
        super().__init__()
        self.p = p
        self.generator = None

    def per_row(self, x):
        return tuple(x.shape[1:])

    def mask(self, x):
        if not self.training or self.p == 0.0:
            return None
        return torch.rand((x.shape[0],) + self.per_row(x),
                          generator=self.generator, device=x.device) >= self.p

    def apply(self, x, keep):
        if keep is None:
            return x
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))

    def forward(self, x):
        return self.apply(x, self.mask(x))


class DropPath(Dropout):
    def per_row(self, x):
        return (1,) * (x.dim() - 1)


class Dropout2d(Dropout):
    def per_row(self, x):
        return (x.shape[1], 1, 1)


def tokens_to_map(x, H, W):
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], H, W)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin, cout, k, stride):
        super().__init__()
        self.proj = Conv(cin, cout, k, stride, k // 2)
        self.norm = LayerNorm(cout, 1e-5)

    def forward(self, x):
        x = self.proj(x)
        H, W = x.shape[-2:]
        return self.norm(x.flatten(2).transpose(1, 2)), H, W


class Attention(nn.Module):
    def __init__(self, dim, heads, sr):
        super().__init__()
        self.heads = heads
        self.q = Linear(dim, dim)
        self.kv = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)
        self.sr_ratio = sr
        if sr > 1:
            self.sr = Conv(dim, dim, sr, sr)
            self.norm = LayerNorm(dim, 1e-5)

    def forward(self, x, H, W):
        B, N, C = x.shape
        h, d = self.heads, C // self.heads
        q = self.q(x).reshape(B, N, h, d).permute(0, 2, 1, 3)
        if self.sr_ratio > 1:
            x = self.norm(self.sr(tokens_to_map(x, H, W))
                          .flatten(2).transpose(1, 2))
        kv = self.kv(x).reshape(B, -1, 2, h, d).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
        scores = _q(_q(q) @ _q(k).transpose(-2, -1)) * d ** -0.5
        p = torch.softmax(scores, dim=-1)
        y = _q(_q(p) @ _q(v))
        return self.proj(y.transpose(1, 2).reshape(B, N, C))


class DWConv(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dwconv = Conv(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x, H, W):
        return self.dwconv(tokens_to_map(x, H, W)).flatten(2).transpose(1, 2)


class MixFFN(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x, H, W):
        return self.fc2(gelu(self.dwconv(self.fc1(x), H, W)))


class Block(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, sr, drop_path):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-6)
        self.attn = Attention(dim, heads, sr)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, 1e-6)
        self.mlp = MixFFN(dim, dim * mlp_ratio)

    def body(self, x, H, W, keep1, keep2):
        x = x + self.drop_path.apply(self.attn(self.norm1(x), H, W), keep1)
        return x + self.drop_path.apply(self.mlp(self.norm2(x), H, W), keep2)

    def forward(self, x, H, W, recompute=False):
        # both masks before the body, in the order the port draws them
        keep1, keep2 = self.drop_path.mask(x), self.drop_path.mask(x)
        if recompute:
            return checkpoint(self.body, x, H, W, keep1, keep2,
                              use_reentrant=False)
        return self.body(x, H, W, keep1, keep2)


class Backbone(nn.Module):
    """`recompute`: checkpoint each block, recomputing it in the backward
    pass; None (the default) does so where the input is on a card and
    gradients are on."""

    def __init__(self, w: Dict):
        super().__init__()
        depths = w["depths"]
        total = sum(depths)
        rates = [w["drop_path"] * i / max(total - 1, 1) for i in range(total)]
        cin = 3
        for i, (c, k, s) in enumerate(zip(w["embed_dims"], w["patch_sizes"],
                                          w["strides"])):
            self.add_module(f"patch_embed{i + 1}",
                            OverlapPatchEmbed(cin, c, k, s))
            cin = c
        at = 0
        for i, (c, n) in enumerate(zip(w["embed_dims"], depths)):
            self.add_module(f"block{i + 1}", nn.ModuleList(
                Block(c, w["num_heads"][i], w["mlp_ratio"],
                      w["sr_ratios"][i], rates[at + j]) for j in range(n)))
            self.add_module(f"norm{i + 1}", LayerNorm(c, 1e-6))
            at += n
        self.stages = len(depths)
        self.recompute = None

    def forward(self, x):
        recompute = self.recompute
        if recompute is None:
            recompute = x.is_cuda and torch.is_grad_enabled()
        outs = []
        for i in range(1, self.stages + 1):
            x, H, W = getattr(self, f"patch_embed{i}")(x)
            for blk in getattr(self, f"block{i}"):
                x = blk(x, H, W, recompute)
            x = tokens_to_map(getattr(self, f"norm{i}")(x), H, W)
            outs.append(x)
        return outs


class LinearEmbed(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.proj = Linear(cin, cout)

    def forward(self, x):
        H, W = x.shape[-2:]
        return tokens_to_map(self.proj(x.flatten(2).transpose(1, 2)), H, W)


class ConvBN(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv(cin, cout, 1, bias=False)
        self.bn = BN(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Head(nn.Module):
    """The all-MLP decoder, then the cosine head; returns (features,
    logits) at stride 4."""

    def __init__(self, dims, num_outputs, channels):
        super().__init__()
        self.proxy = nn.Parameter(torch.empty(num_outputs, channels, 1, 1))
        for i in reversed(range(len(dims))):
            self.add_module(f"linear_c{i + 1}", LinearEmbed(dims[i], channels))
        self.linear_fuse = ConvBN(len(dims) * channels, channels)
        self.dropout = Dropout2d(0.1)

    def forward(self, feats):
        size = feats[0].shape[-2:]
        y = torch.cat([F.interpolate(
            getattr(self, f"linear_c{i + 1}")(feats[i]), size=size,
            mode="bilinear", align_corners=False)
            for i in reversed(range(len(feats)))], dim=1)
        y = self.dropout(self.linear_fuse(y))
        feat = y / torch.sqrt((y * y).sum(1, keepdim=True) + 1e-12)
        p = self.proxy[:, :, 0, 0]
        p = p / torch.sqrt((p * p).sum(1, keepdim=True) + 1e-12)
        return feat, torch.einsum("bchw,nc->bnhw", feat, p)


def check(cfg: Dict) -> Dict:
    """The configuration's widths, after checking `model` and
    `output_stride` against them."""
    head = cfg["model"].partition("_")[0]
    if head != "segformerwn":
        raise ValueError(f"configuration key 'model': {cfg['model']!r} "
                         f"names the head {head!r}; the reference builds "
                         f"segformerwn")
    w = cfg["widths"]
    if cfg["output_stride"] != math.prod(w["strides"]):
        raise ValueError(f"configuration key 'output_stride': "
                         f"{cfg['output_stride']}, the strides "
                         f"{w['strides']} give {math.prod(w['strides'])}")
    return w


class Net(nn.Module):
    """forward(x) -> logits (B, N, H, W) at the input size; with
    return_feat, (features, logits), both upsampled."""

    def __init__(self, cfg: Dict):
        super().__init__()
        w = check(cfg)
        self.backbone = Backbone(w)
        self.classifier = Head(w["embed_dims"], cfg["num_outputs"],
                               w["decoder_channels"])

    def forward(self, x, return_feat=False):
        size = x.shape[-2:]
        feat, logits = self.classifier(self.backbone(x))
        up = lambda t: F.interpolate(t, size=size, mode="bilinear",  # noqa
                                     align_corners=False)
        if return_feat:
            return up(feat), up(logits)
        return up(logits)


def weight_rule(net: nn.Module, cfg: Dict
                ) -> Tuple[List[Tuple[str, float]], Dict[str, float]]:
    """The leaves drawn from the seed, in draw order, each with its
    standard deviation: Linear weights 0.02, convolution weights
    sqrt(2 / (k^2 out / groups)) (NVlabs' _init_weights), class proxies
    Kaiming-normal over their fan-in. The fill of every other leaf:
    biases 0, LayerNorm and BN scale 1, running mean 0 and variance 1."""
    std = {}
    for n, m in net.named_modules():
        if isinstance(m, Linear):
            std[f"{n}.weight"] = 0.02
        elif isinstance(m, Conv):
            o, _, kh, kw = m.weight.shape
            std[f"{n}.weight"] = math.sqrt(2.0 / (kh * kw * o / m.groups))
        elif isinstance(m, Head):
            std[f"{n}.proxy"] = math.sqrt(2.0 / m.proxy[0].numel())
    drawn = [(n, std[n]) for n, _ in net.named_parameters() if n in std]
    fill = {n: 0.0 if n.endswith("bias") else 1.0
            for n, _ in net.named_parameters() if n not in std}
    fill.update({n: 1.0 if n.endswith("running_var") else 0.0
                 for n, _ in net.named_buffers()})
    return drawn, fill


def dropouts(net: nn.Module):
    return [m for m in net.modules() if isinstance(m, Dropout)]
