"""Simple pseudo-label generators: the port of mulactseg_tpu/plbl/simple.py,
on channel-first logits ((B, C, H, W), or (C, H, W) where noted).

within_multihot_plbl: the top-1 class within the candidate set for every
pixel of a selected superpixel (trainer/eval_within_multihot.py:95-146).
The reference multiplies the raw logits by the candidate mask, not the
softmax, and so does this copy: a pixel whose candidate logits are all
negative can take a non-candidate class, whose masked logit is 0.

naive_argmax_plbl: argmax over the first num_real_classes channels
inside the selected superpixels (trainer/eval_save_cosplbl_naive_voc.py).

naive_threshold_plbl, naive_threshold_fill: eval_save_naiveplbl's map and
the *_prop / *_naiveprop fill step.

Ties go to the first index (torch.argmax, as jnp.argmax).
"""

from __future__ import annotations

import torch


def within_multihot_plbl(logits, targets, spx, spmask, ignore_value=255):
    """logits (B, C, H, W); targets (B, S, C) multi-hot; spx, spmask
    (B, H, W). Returns (B, H, W) int32 labels, `ignore_value` outside
    spmask."""
    B, C, H, W = logits.shape
    S = targets.shape[1]
    if targets.shape[-1] != C:
        raise ValueError(f"{targets.shape[-1]} candidate columns for {C} "
                         "logit channels")
    sid = spx.reshape(B, H * W).long().clamp(0, S - 1)
    trg = torch.gather(targets.to(logits.dtype), 1,
                       sid[:, :, None].expand(B, H * W, C))  # (B, P, C)
    masked = logits.reshape(B, C, H * W) * trg.transpose(1, 2)
    plbl = masked.argmax(dim=1).int().view(B, H, W)
    return torch.where(spmask.bool(), plbl, ignore_value).int()


def naive_argmax_plbl(logits, spmask, *, num_real_classes: int,
                      ignore_value=255):
    """Argmax over the first num_real_classes channels (dim -3) inside
    spmask."""
    plbl = logits[..., :num_real_classes, :, :].argmax(dim=-3).int()
    return torch.where(spmask.bool(), plbl, ignore_value).int()


def naive_threshold_plbl(logits, spmask, *, plbl_th=0.0, ignore_value=255):
    """eval_save_naiveplbl (trainer/eval_save_naiveplbl.py:50-56): the
    top-1 over all channels (dim -3); with plbl_th > 0 the mask is the
    pixels whose (no-temperature) softmax confidence passes plbl_th, over
    the whole image, in place of spmask."""
    if plbl_th > 0:
        probs = torch.softmax(logits.float(), dim=-3)
        mask = probs.amax(dim=-3) > plbl_th
    else:
        mask = spmask.bool()
    plbl = logits.argmax(dim=-3).int()
    return torch.where(mask, plbl, ignore_value).int()


def naive_threshold_fill(plbl, logits, spmask, *, temp, plbl_th):
    """The fill step of eval_save_candidateplbl_prop.py:48-60 and
    eval_save_cosplbl_naiveprop.py:57-67: pixels outside spmask whose
    temperature-softmax top-1 confidence passes plbl_th take that class,
    over the incoming label. plbl, spmask (H, W); logits (C, H, W)."""
    probs = torch.softmax(logits.float() / temp, dim=-3)
    conf, cls = probs.max(dim=-3)
    fill = (conf > plbl_th) & ~spmask.bool()
    return torch.where(fill, cls.to(plbl.dtype), plbl)
