"""SegFormer (Xie et al., NeurIPS 2021, arXiv:2105.15203): the Mix
Transformer backbone and the all-MLP decoder, with MulActSeg's cosine
head in place of the published 1x1 classifier. An architecture of the
port alone: the JAX package has no counterpart, and the benchmark's plain
reference (benchmark/reference/segformer.py) is what it is held to.

Module and parameter names follow NVlabs/SegFormer
(mmseg/models/backbones/mix_transformer.py, decode_heads/segformer_head.py),
so that checkpoint's weights would load by name:

  backbone.patch_embed{1..4}.{proj, norm}   overlapping patch embeddings
  backbone.block{1..4}.<j>.norm1, .attn.{q, kv, proj}, .attn.{sr, norm}
      (where sr > 1), .norm2, .mlp.{fc1, dwconv.dwconv, fc2}
  backbone.norm{1..4}                       the stage-end LayerNorms
  classifier.linear_c{1..4}.proj, .linear_fuse.{conv, bn}, .proxy

A block is pre-LN: x + drop_path(attn(norm1(x))), then x +
drop_path(mlp(norm2(x))). The attention is efficient self-attention:
queries at every token, keys and values from a strided `sr` convolution
and a LayerNorm, through F.scaled_dot_product_attention. The Mix-FFN is
Linear, depthwise 3x3, exact GELU, Linear. The decoder projects each
stage to `decoder_channels`, resizes it to stride 4, concatenates
c4, c3, c2, c1, fuses them with a 1x1 convolution, BN and ReLU, drops
channels (Dropout2d) and hands the result to models/deeplab.cosine_logits.

Spans (utils/spans.py): model.stage1 .. model.stage4 around each stage of
the backbone, model.decode around the head; five a forward.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mulactseg_tpu_torch.models.deeplab import DeepLabV3, cosine_logits
from mulactseg_tpu_torch.models.layers import (
    Dropout2d,
    DropPath,
    FastBatchNorm,
    resize_bilinear,
)
from mulactseg_tpu_torch.ops import _build
from mulactseg_tpu_torch.utils.spans import span

# mit_b5 (mix_transformer.py class mit_b5) and SegFormerHead's embed_dim
MIT_B5 = dict(embed_dims=(64, 128, 320, 512), depths=(3, 6, 40, 3),
              num_heads=(1, 2, 5, 8), sr_ratios=(8, 4, 2, 1), mlp_ratio=4,
              patch_sizes=(7, 3, 3, 3), strides=(4, 2, 2, 2),
              decoder_channels=768, drop_path=0.1)


def attention(q, k, v):
    """softmax(q k^T / sqrt(d)) v of q (B, h, N, d) against k, v (B, h, M,
    d), with no dropout. On the card only the flash, cuDNN and efficient
    kernels may run it: a shape or dtype that none takes raises, where the
    math backend would build the (B, h, N, M) matrix. Counts the call and
    the products a bound needs in ops/_build.LAUNCHES: `sdpa`,
    `sdpa.bhnmd` (B h N M d) and `sdpa.bhnpmd` (B h (N + M) d)."""
    B, h, N, d = q.shape
    M = k.shape[2]
    _build.LAUNCHES["sdpa"] += 1
    _build.LAUNCHES["sdpa.bhnmd"] += B * h * N * M * d
    _build.LAUNCHES["sdpa.bhnpmd"] += B * h * (N + M) * d
    if not q.is_cuda:
        return F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        return F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)


def _tokens_to_map(x, H: int, W: int):
    """(B, H*W, C) tokens -> (B, C, H, W)."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], H, W)


class OverlapPatchEmbed(nn.Module):
    """A strided convolution with padding k // 2, then LayerNorm over the
    tokens; returns (B, H*W, C), H, W."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, k, stride, k // 2)
        self.norm = nn.LayerNorm(cout)

    def forward(self, x):
        x = self.proj(x)
        H, W = x.shape[-2:]
        return self.norm(x.flatten(2).transpose(1, 2)), H, W


class Attention(nn.Module):
    """Efficient self-attention: keys and values from tokens reduced by a
    sr x sr convolution of stride sr and a LayerNorm (sr > 1)."""

    def __init__(self, dim: int, heads: int, sr: int):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr > 1:
            self.sr = nn.Conv2d(dim, dim, sr, sr)
            self.norm = nn.LayerNorm(dim)
        else:
            self.sr = None

    def forward(self, x, H: int, W: int):
        B, N, C = x.shape
        h = self.heads
        q = self.q(x).reshape(B, N, h, C // h).transpose(1, 2)
        if self.sr is not None:
            x = self.norm(self.sr(_tokens_to_map(x, H, W))
                          .flatten(2).transpose(1, 2))
        kv = self.kv(x).reshape(B, -1, 2, h, C // h).permute(2, 0, 3, 1, 4)
        y = attention(q, kv[0], kv[1])
        return self.proj(y.transpose(1, 2).reshape(B, N, C))


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x, H: int, W: int):
        return self.dwconv(_tokens_to_map(x, H, W)).flatten(2).transpose(1, 2)


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, H: int, W: int):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), H, W)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int, sr: int,
                 drop_path: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, sr)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MixFFN(dim, dim * mlp_ratio)

    def forward(self, x, H: int, W: int):
        x = x + self.drop_path(self.attn(self.norm1(x), H, W))
        return x + self.drop_path(self.mlp(self.norm2(x), H, W))


class MixTransformer(nn.Module):
    """The backbone: four stages of a patch embedding, blocks and a
    LayerNorm; forward returns the four (B, C_i, H_i, W_i) stage outputs.
    Drop-path rates rise linearly from 0 over all the blocks."""

    def __init__(self, embed_dims: Sequence[int], depths: Sequence[int],
                 num_heads: Sequence[int], sr_ratios: Sequence[int],
                 mlp_ratio: int, patch_sizes: Sequence[int],
                 strides: Sequence[int], drop_path: float):
        super().__init__()
        total = sum(depths)
        rates = [drop_path * i / max(total - 1, 1) for i in range(total)]
        cin = 3
        for i, (c, k, s) in enumerate(zip(embed_dims, patch_sizes, strides)):
            self.add_module(f"patch_embed{i + 1}",
                            OverlapPatchEmbed(cin, c, k, s))
            cin = c
        at = 0
        for i, (c, n) in enumerate(zip(embed_dims, depths)):
            self.add_module(f"block{i + 1}", nn.ModuleList(
                Block(c, num_heads[i], mlp_ratio, sr_ratios[i],
                      rates[at + j]) for j in range(n)))
            self.add_module(f"norm{i + 1}", nn.LayerNorm(c, eps=1e-6))
            at += n
        self.stages = len(embed_dims)

    def forward(self, x):
        outs = []
        for i in range(1, self.stages + 1):
            with span(f"model.stage{i}"):
                x, H, W = getattr(self, f"patch_embed{i}")(x)
                for blk in getattr(self, f"block{i}"):
                    x = blk(x, H, W)
                x = _tokens_to_map(getattr(self, f"norm{i}")(x), H, W)
            outs.append(x)
        return outs


class LinearEmbed(nn.Module):
    """SegFormerHead's MLP: a (B, C, H, W) map's tokens through one Linear,
    back to (B, E, H, W)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Linear(cin, cout)

    def forward(self, x):
        H, W = x.shape[-2:]
        return _tokens_to_map(self.proj(x.flatten(2).transpose(1, 2)), H, W)


class ConvBN(nn.Module):
    """mmcv's ConvModule as the head's linear_fuse: a 1x1 convolution
    without bias, BN, ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn = FastBatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class SegFormerHead(nn.Module):
    """The all-MLP decoder with the cosine head (models/deeplab.py
    cosine_logits) in place of linear_pred; return_feat hands back the
    normalised features at stride 4; channel-wise dropout at 0.1, as
    segformer_head.py's dropout_ratio."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 channels: int):
        super().__init__()
        self.proxy = nn.Parameter(torch.empty(num_classes, channels, 1, 1))
        for i in reversed(range(len(in_channels))):
            self.add_module(f"linear_c{i + 1}",
                            LinearEmbed(in_channels[i], channels))
        self.linear_fuse = ConvBN(len(in_channels) * channels, channels)
        self.dropout = Dropout2d(0.1)

    def forward(self, feats, return_feat: bool = False):
        with span("model.decode"):
            size = feats[0].shape[-2:]
            y = torch.cat([resize_bilinear(
                getattr(self, f"linear_c{i + 1}")(feats[i]), size)
                for i in reversed(range(len(feats)))], dim=1)
            y = self.dropout(self.linear_fuse(y))
            feat, logits = cosine_logits(y, self.proxy)
        if return_feat:
            return feat, logits
        return logits


def segformer(num_classes: int, widths: Optional[dict] = None) -> DeepLabV3:
    """SegFormer at `widths` (MIT_B5's keys; MIT_B5 when None) in the
    port's DeepLabV3 container, its weights left empty (init_weights)."""
    w = dict(MIT_B5, **(widths or {}))
    decoder = w.pop("decoder_channels")
    return DeepLabV3(MixTransformer(**w),
                     SegFormerHead(w["embed_dims"], num_classes, decoder))


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """NVlabs' _init_weights, drawn from `generator` as plain normals:
    Linear N(0, 0.02^2) (trunc_normal_'s bounds of +-2 lie 100 sigma out),
    convolutions N(0, 2 / (k^2 out / groups)), biases 0, LayerNorm and BN
    scale 1 and shift 0; the cosine head's proxies Kaiming-normal over
    their fan-in."""
    def draw(t, std):
        w = torch.empty(t.shape)
        w.normal_(0.0, std, generator=generator)
        t.copy_(w)

    for m in model.modules():
        if isinstance(m, nn.Linear):
            draw(m.weight, 0.02)
        elif isinstance(m, nn.Conv2d):
            k = m.kernel_size[0] * m.kernel_size[1]
            draw(m.weight, math.sqrt(2.0 / (k * m.out_channels / m.groups)))
        elif isinstance(m, SegFormerHead):
            draw(m.proxy, math.sqrt(2.0 / m.proxy[0].numel()))
        if isinstance(m, (nn.Linear, nn.Conv2d)) and m.bias is not None:
            m.bias.zero_()
