"""Mixed-superpixel-scale (mseg) partial-label loss: the port of
mulactseg_tpu/losses/mseg.py (:39-106), on float32 NCHW logits.

An image carries annotations at several superpixel granularities
(nseg_list, ascending), stacked on a level axis: spx_levels and
spmask_levels (B, S, H, W), absent levels all-False in spmask, so they
add nothing. Both terms sum over every level with one batch-global
normaliser, 1 + the count (under data parallelism the global batch's,
parallel/mesh.global_count). The group term takes each level's
per-(superpixel, class) max of each image's softmax through
ops/segment_max.segment_max_grad (K5 once an image and level on the
card), and the max carries the gradient to its argmax pixel.

The JAX package's quirks, kept: the group term's temperature is the
caller's (the criterion pins it to 1.0, as the reference hard-codes it);
the MC term counts every spmask pixel; the total is coeff * mc + group.
A pixel whose id is out of its level's range (the crop padding) gathers
a NaN target row, as jnp.take_along_axis fills it (partial.py's
_pixel_targets); spmask excludes it from the loss.
"""

from __future__ import annotations

from typing import Sequence

import torch

from mulactseg_tpu_torch.losses.partial import (
    _pixel_targets,
    _segment_max,
    _softmax,
)
from mulactseg_tpu_torch.parallel import mesh

EPS = 1e-8


def mseg_multi_choice_ce(logits, targets_by_level: Sequence[torch.Tensor],
                         spx_levels, spmask_levels, *, temp=1.0):
    """Merged-positive CE over every annotation level (mseg.py:39-65).
    logits (B, C, H, W); targets_by_level: per level (B, nseg_s, C)."""
    B = logits.shape[0]
    probs = _softmax(logits, temp)
    loss = probs.new_zeros(())
    count = torch.zeros((), dtype=torch.long, device=probs.device)
    for s in range(spx_levels.shape[1]):
        spx = spx_levels[:, s].reshape(B, -1).long()
        mask = spmask_levels[:, s].reshape(B, -1).bool()
        trg_pixel = _pixel_targets(targets_by_level[s].float(), spx)
        nll = -torch.log((probs * trg_pixel).sum(dim=1) + EPS)
        loss = loss + torch.where(mask, nll, 0.0).sum()
        count = count + mask.sum()
    return loss / (1.0 + mesh.global_count(count)).to(loss.dtype)


def mseg_group_multi_label_ce(logits, targets_by_level, spx_levels,
                              spmask_levels, *, nseg_list: Sequence[int],
                              temp=1.0):
    """MIL group loss over every annotation level (mseg.py:68-93): per
    present (superpixel, candidate class) pair, -log of the max
    probability inside the superpixel."""
    B = logits.shape[0]
    probs = _softmax(logits, temp)
    loss = probs.new_zeros(())
    count = torch.zeros((), dtype=torch.long, device=probs.device)
    for s in range(spx_levels.shape[1]):
        nseg = int(nseg_list[s])
        spx = spx_levels[:, s].reshape(B, -1).long()
        mask = spmask_levels[:, s].reshape(B, -1).bool()
        sid = torch.where(mask, spx, nseg).int()
        mx, present = _segment_max(probs, sid, nseg)
        entry = (targets_by_level[s] > 0.5) & present[:, :, None]
        loss = loss + torch.where(entry, -torch.log(mx + EPS), 0.0).sum()
        count = count + entry.sum()
    return loss / (1.0 + mesh.global_count(count)).to(loss.dtype)


def mseg_joint_loss(logits, targets_by_level, spx_levels, spmask_levels, *,
                    nseg_list, coeff=16.0, multi_ce_temp=0.1,
                    group_ce_temp=1.0):
    """coeff * MC + group (mseg.py:96-106)."""
    pos = mseg_multi_choice_ce(logits, targets_by_level, spx_levels,
                               spmask_levels, temp=multi_ce_temp)
    group = mseg_group_multi_label_ce(logits, targets_by_level, spx_levels,
                                      spmask_levels, nseg_list=nseg_list,
                                      temp=group_ce_temp)
    total = coeff * pos + group
    return total, {"train_loss": total, "pos_loss": pos, "group_loss": group}
