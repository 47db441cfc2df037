"""Fused stage-1 lossdecomp over per-pixel target bitmasks: the port of
mulactseg_tpu/losses/fused.py.

coeff*CE(one-hot pixels) + coeff_mc*MC(multi-hot pixels) +
coeff_gm*Group(multi-hot segments), normalisers 1 + count. The CE and MC
terms are one pass over the logits (ops/pixel_loss.py, kernels K1/K2);
the group term is a per-(segment, class) softmax max (ops/segment.py,
kernels K3/K4). The JAX package zero-pads HW to a multiple of its TPU
block; here P = B*H*W exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from mulactseg_tpu_torch.ops.pixel_loss import pixel_partial_ce_nchw
from mulactseg_tpu_torch.ops.segment import segment_softmax_max_nchw

EPS = 1e-8


def pixel_target_bits(target: np.ndarray, spx: np.ndarray,
                      spmask: np.ndarray) -> np.ndarray:
    """Loader-side packer: (S, C<=31) multi-hot + (H, W) spx + (H, W)
    selected-mask -> (H, W) int32 candidate bitmask (0 = invalid pixel).
    Crop padding writes nseg into spx; those pixels are never selected, so
    the lookup is clipped and the mask zeroes them (fused.py:33-51)."""
    C = target.shape[-1]
    if C > 31:
        raise ValueError(f"at most 31 classes fit an int32 bitmask, got {C}")
    weights = (1 << np.arange(C, dtype=np.int64))
    seg_bits = ((target > 0.5).astype(np.int64) * weights).sum(-1)
    spx_c = np.minimum(spx, seg_bits.shape[0] - 1)
    return (seg_bits[spx_c] * spmask).astype(np.int32)


def bits_to_multihot(bits: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(...,) int32 -> (..., C) float32 candidate indicator."""
    shifts = torch.arange(num_classes, dtype=torch.int32, device=bits.device)
    return ((bits.int()[..., None] >> shifts) & 1).float()


def _popcount(v: torch.Tensor) -> torch.Tensor:
    """Bit count of non-negative int64 values below 2**32."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    return (((v + (v >> 4)) & 0x0F0F0F0F) * 0x01010101 >> 24) & 0xFF


def lossdecomp_fused(logits, target_bits, targets, spx, *, nseg: int,
                     coeff=16.0, coeff_mc=8.0, coeff_gm=1.0,
                     multi_ce_temp=0.1, group_ce_temp=0.1):
    """logits (B, C, H, W) float32, the model's NCHW layout (the JAX
    package's nchw=True); target_bits (B, H, W) int32; targets
    (B, nseg, C); spx (B, H, W) int. Returns (total, aux)."""
    B, C, H, W = logits.shape
    HW = H * W
    lgc = logits.reshape(B, C, HW).contiguous()
    P = B * HW
    bits3 = target_bits.reshape(B, 1, HW).int().contiguous()

    sums = pixel_partial_ce_nchw(lgc, bits3, multi_ce_temp)
    ce = sums[0] / (1.0 + sums[1])
    mc = sums[2] / (1.0 + sums[3])

    # group term: multi-hot pixels (popcount of the low C bits > 1) feed a
    # per-(segment, class) max; batch folded into the segment axis
    # (sid = spx + b*nseg), invalid pixels at B*nseg
    mh_pix = _popcount(bits3.reshape(P).long() & ((1 << C) - 1)) > 1
    off = torch.arange(B, device=lgc.device).repeat_interleave(HW) * nseg
    sid = torch.where(mh_pix, spx.reshape(P).long() + off, B * nseg)
    mx, pix = segment_softmax_max_nchw(
        lgc, sid.int().reshape(B, 1, HW).contiguous(), B * nseg,
        group_ce_temp)
    mx = mx.reshape(B, nseg, C)
    # presence is read from class 0's argmax (fused.py:132)
    present = (pix[:, 0] < P).reshape(B, nseg)
    entry = (targets > 0.5) & present[:, :, None]
    gnll = -torch.log(mx + EPS)
    group = torch.where(entry, gnll, torch.zeros((), device=gnll.device)
                        ).sum() / (1.0 + entry.sum())

    total = coeff * ce + coeff_mc * mc + coeff_gm * group
    return total, {"ce_loss": ce, "mc_loss": mc, "group_loss": group,
                   "train_loss": total}
