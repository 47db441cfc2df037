"""Hierarchy (two-scale superpixel) group losses: the port of
mulactseg_tpu/losses/hier.py (:32-184), on float32 NCHW logits.

For every (big superpixel, annotated class) pair the argmax pixel of the
class's probability under the big superpixel is found (K5 on the card,
through ops/segment_max.segment_max_grad), and the class's NLL summed
over the *small* superpixel holding that pixel is the pair's loss; the
total is over 1 + the summed sizes of those small superpixels. The async
variant picks the pairs on a weak view (its own argmax and small map) and
applies them to the strong view's NLL sums; with weight_reduce 'max' or
'mean' each pair is scaled by the weak view's max (K5 again, over the
fine map) or mean probability of its class in the small superpixel. The
aug variant drops the labels of big superpixels touching the crop border.

The sums over the small superpixels (the JAX package's seg_sum and
seg_count, plain XLA there) are index_add_ and bincount here, as
acquisition/scoring.py makes them. The JAX package's hierarchy loss also
takes gumbel_scale and a key; its only callers pass no key, so the noise
is never drawn, and the port has no such path.

Under data parallelism the normaliser counts the global batch
(parallel/mesh.global_count); the argmaxes, the small-superpixel sums
and weight_reduce's per-segment max and mean stay per image.
"""

from __future__ import annotations

from typing import Optional

import torch

from mulactseg_tpu_torch.losses.partial import _softmax
from mulactseg_tpu_torch.ops.segment_max import segment_max_grad
from mulactseg_tpu_torch.parallel import mesh

EPS = 1e-8


def _pairs_from_argmax(probs, sid_big, nseg, trg, only_single):
    """probs (C, P) one image's planes, sid_big (P,) int32 with invalid ==
    nseg, trg (S, C) -> (pair mask (S, C), argmax pixel (S, C) long)."""
    _, argpix = segment_max_grad(probs.t(), sid_big.contiguous(), nseg)
    present = argpix[:, 0] < probs.shape[1]
    pair = (trg > 0.5) & present[:, None]
    if only_single:
        pair = pair & (trg.sum(dim=-1) > 1)[:, None]
    return pair, argpix.long()


def _small_at(small, argpix, small_nseg):
    """The small superpixel id at each argmax pixel, small_nseg where the
    segment is absent (argpix == P)."""
    pad = small.new_full((1,), small_nseg)
    return torch.cat([small, pad])[argpix.clamp(0, small.shape[0])]


def _small_sums(probs, sid_small, small_nseg):
    """(C, S_small) sums of -log(p + EPS) over each small superpixel's
    valid pixels and (S_small,) their sizes; sid_small (P,) with invalid
    == small_nseg."""
    C = probs.shape[0]
    nll = -torch.log(probs + EPS)
    sums = nll.new_zeros(C, small_nseg + 1).index_add_(1, sid_small, nll)
    sizes = torch.bincount(sid_small, minlength=small_nseg + 1)
    return sums[:, :small_nseg], sizes[:small_nseg]


def _at_pairs(table, small_c):
    """table (C, S_small), small_c (S, C) -> (S, C) table[c, small_c[s, c]]."""
    return table.gather(1, small_c.t()).t()


def hier_group_multi_label_ce(logits, targets, spx, spx_small, spmask, *,
                              nseg, small_nseg, temp=1.0, only_single=False):
    """HierGroupMultiLabelCE (hier.py:53-94). logits (B, C, H, W), targets
    (B, nseg, C + 1) (the last channel dropped, as the reference does),
    spx and spx_small (B, H, W), spmask (B, H, W)."""
    probs = _softmax(logits, temp)
    B, C, P = probs.shape
    trg = targets[..., :-1].float()
    spx = spx.reshape(B, P).long()
    small = spx_small.reshape(B, P).long()
    mask = spmask.reshape(B, P).bool()
    loss, num = probs.new_zeros(()), torch.zeros((), dtype=torch.long,
                                                 device=probs.device)
    for b in range(B):
        sid_big = torch.where(mask[b], spx[b], nseg).int()
        sid_small = torch.where(mask[b], small[b], small_nseg)
        pair, argpix = _pairs_from_argmax(probs[b], sid_big, nseg, trg[b],
                                          only_single)
        small_at = _small_at(small[b], argpix, small_nseg)
        sums, sizes = _small_sums(probs[b], sid_small, small_nseg)
        small_c = small_at.clamp(0, small_nseg - 1)
        ok = pair & (small_at < small_nseg)
        loss = loss + torch.where(ok, _at_pairs(sums, small_c), 0.0).sum()
        num = num + torch.where(ok, sizes[small_c], 0).sum()
    return loss / (1.0 + mesh.global_count(num)).to(loss.dtype)


def async_hier_group_multi_label_ce(
        logits_strong, logits_weak, targets, spx_weak, spx_small_strong,
        spx_small_weak, spmask_strong, spmask_weak, *, nseg, small_nseg,
        temp=1.0, weight_reduce: Optional[str] = None):
    """Async(Weight)HierGroupMultiLabelCE (hier.py:97-154): the (small
    superpixel, class) pairs picked on the weak view's big-superpixel
    argmax, the loss taken from the strong view's small-superpixel NLL
    sums. A pair whose value is exactly 0 (its small superpixel absent
    from the strong view, an empty sum) leaves the normaliser, as the
    reference's value.nonzero() filter does. weight_reduce None, 'max' or
    'mean'. The weak logits carry no gradient."""
    if weight_reduce not in (None, "max", "mean"):
        raise ValueError(f"weight_reduce {weight_reduce!r}: want None, "
                         "'max' or 'mean'")
    probs_s = _softmax(logits_strong, temp)
    probs_w = _softmax(logits_weak.detach(), temp)
    B, C, P_s = probs_s.shape
    P_w = probs_w.shape[-1]
    trg = targets[..., :-1].float()
    spx_w = spx_weak.reshape(B, P_w).long()
    small_s = spx_small_strong.reshape(B, P_s).long()
    small_w = spx_small_weak.reshape(B, P_w).long()
    mask_s = spmask_strong.reshape(B, P_s).bool()
    mask_w = spmask_weak.reshape(B, P_w).bool()
    loss, num = probs_s.new_zeros(()), torch.zeros((), dtype=torch.long,
                                                   device=probs_s.device)
    for b in range(B):
        sid_big_w = torch.where(mask_w[b], spx_w[b], nseg).int()
        pair, argpix_w = _pairs_from_argmax(probs_w[b], sid_big_w, nseg,
                                            trg[b], False)
        small_at = _small_at(small_w[b], argpix_w, small_nseg)
        sid_small_s = torch.where(mask_s[b], small_s[b], small_nseg)
        sums, sizes = _small_sums(probs_s[b], sid_small_s, small_nseg)
        small_c = small_at.clamp(0, small_nseg - 1)
        val = _at_pairs(sums, small_c)
        if weight_reduce is not None:
            sid_small_w = torch.where(mask_w[b], small_w[b], small_nseg)
            if weight_reduce == "max":
                red, _ = segment_max_grad(probs_w[b].t(),
                                          sid_small_w.int().contiguous(),
                                          small_nseg)
                red = red.t()
            else:
                tot = probs_w.new_zeros(C, small_nseg + 1).index_add_(
                    1, sid_small_w, probs_w[b])[:, :small_nseg]
                n = torch.bincount(sid_small_w, minlength=small_nseg + 1)[
                    :small_nseg]
                red = torch.where(n > 0, tot / n.clamp(min=1), 0.0)
            val = val * _at_pairs(red, small_c).detach()
        kept = pair & (small_at < small_nseg)
        loss = loss + torch.where(kept, val, 0.0).sum()
        num = num + torch.where(kept & (val != 0), sizes[small_c], 0).sum()
    return loss / (1.0 + mesh.global_count(num)).to(loss.dtype)


def border_spx_ids_mask(spx_2d, nseg):
    """(nseg,) bool: the superpixels touching the crop border (hier.py:
    157-162); ids outside [0, nseg) (the crop padding) are no superpixel."""
    border = torch.cat([spx_2d[0], spx_2d[-1], spx_2d[:, 0],
                        spx_2d[:, -1]]).long()
    hit = torch.zeros(nseg + 1, dtype=torch.bool, device=spx_2d.device)
    hit[torch.where((border >= 0) & (border < nseg), border, nseg)] = True
    return hit[:nseg]


def aug_hier_group_multi_label_ce(logits, targets, spx, spx_small, spmask,
                                  *, nseg, small_nseg, temp=1.0,
                                  only_single=False):
    """AugHierGroupMultiLabelCE (hier.py:165-184): the hierarchy loss with
    the labels of border-touching superpixels removed per image."""
    trg = targets.float()[..., :-1]
    border = torch.stack([border_spx_ids_mask(s, nseg) for s in spx])
    trg = torch.where(border[..., None], 0.0, trg)
    # a dummy last channel, which hier_group_multi_label_ce slices off
    trg_full = torch.cat([trg, trg.new_zeros(trg.shape[:-1] + (1,))], -1)
    return hier_group_multi_label_ce(
        logits, trg_full, spx, spx_small, spmask, nseg=nseg,
        small_nseg=small_nseg, temp=temp, only_single=only_single)
