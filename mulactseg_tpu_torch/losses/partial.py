"""Partial-label losses over superpixel regions: the port of
mulactseg_tpu/losses/partial.py.

Same formulas and normalisers as the JAX package (num_valid starts at 1
and counts over the whole batch: under data parallelism the global
batch, _norm), on the port's float32 NCHW logits
(B, C, H, W): the softmax and the per-pixel candidate rows stay (B, C, P)
with P = H * W, so no full-resolution transpose is made.
  - `targets` are the per-superpixel multi-hot annotations (B, S, C_t),
    C_t = num_classes + 1 (the last channel "undefined");
  - slice_last=True drops that channel, slice_last=False keeps it (the
    predignore criteria, whose model predicts the undefined class);
  - a pixel whose superpixel id is out of range (crop padding writes
    nseg) gathers a NaN row, as jnp.take_along_axis fills it; such pixels
    are never selected.
The group terms take a per-(segment, class) max of each image's softmax
through ops/segment_max.segment_max_grad (kernel K5 on the card), on the
image's (C, P) planes seen as (P, C) through .t(): K5's PLANES load path,
no copy.
"""

from __future__ import annotations

import torch

from mulactseg_tpu_torch.ops.segment_max import seg_max_fwd, segment_max_grad
from mulactseg_tpu_torch.parallel import mesh

EPS = 1e-8


def _norm(total, count):
    """total / (1 + the global batch's count): under data parallelism the
    count is summed over the ranks (parallel/mesh.global_count) and the
    1 added once, so each rank's loss is its share of the global one."""
    return total / (1.0 + mesh.global_count(count)).to(total.dtype)


def _softmax(logits, temp):
    """(B, C, H, W) -> float32 softmax over the classes, (B, C, H * W)."""
    B, C = logits.shape[:2]
    return torch.softmax(logits.float().reshape(B, C, -1) / temp, dim=1)


def _flatten(logits, targets, spx, spmask, temp, slice_last):
    B, C, H, W = logits.shape
    probs = _softmax(logits, temp)
    spx = spx.reshape(B, H * W).long()
    mask = spmask.reshape(B, H * W).bool()
    trg = targets[..., :-1] if slice_last else targets
    trg = trg.float()
    if trg.shape[-1] != C:
        raise ValueError(
            f"target channels {trg.shape[-1]} != logit channels {C} "
            f"(slice_last={slice_last})")
    return probs, trg, spx, mask


def _pixel_targets(trg, spx):
    """Each pixel's superpixel multi-hot: (B, S, C), (B, P) -> (B, C, P);
    NaN rows where the id is out of range."""
    B, S, C = trg.shape
    idx = spx.clamp(0, S - 1)[:, None, :].expand(-1, C, -1)
    rows = trg.transpose(1, 2).gather(2, idx)
    return torch.where((spx < S)[:, None, :], rows, float("nan"))


def _where_sum(cond, x):
    return torch.where(cond, x, 0.0).sum()


def _segment_max(probs, sid, nseg):
    """Per image b: segment_max_grad over probs[b]'s planes -> ((B, S, C)
    max, (B, S) present), one K5 launch an image."""
    P = probs.shape[-1]
    mx, present = [], []
    for b in range(probs.shape[0]):
        m, argpix = segment_max_grad(probs[b].t(), sid[b].contiguous(), nseg)
        mx.append(m)
        present.append(argpix[:, 0] < P)
    return torch.stack(mx), torch.stack(present)


def multi_choice_ce(logits, targets, spx, spmask, *, temp=1.0,
                    slice_last=True):
    """Merged-positive CE (L_mp): -log sum_{c in candidates} p_c per pixel
    (partial.py:46-61)."""
    probs, trg, spx, mask = _flatten(logits, targets, spx, spmask, temp,
                                     slice_last)
    trg_pixel = _pixel_targets(trg, spx)
    valid = mask & (trg_pixel > 0).any(dim=1)
    nll = -torch.log((probs * trg_pixel).sum(dim=1) + EPS)
    return _norm(_where_sum(valid, nll), valid.sum())


def group_multi_label_ce(logits, targets, spx, spmask, *, nseg, temp=1.0,
                         slice_last=True, only_multi=False,
                         pixel_multi_mask=None):
    """MIL group loss (L_gm, partial.py:64-107): per present (superpixel,
    candidate class) pair, -log of the max probability inside the
    superpixel. only_multi: only pixels of multi-hot superpixels feed the
    max (pixel_multi_mask, when given, is that per-pixel mask)."""
    probs, trg, spx, mask = _flatten(logits, targets, spx, spmask, temp,
                                     slice_last)
    if only_multi:
        if pixel_multi_mask is not None:
            pix_multi = pixel_multi_mask.reshape(mask.shape)
        else:
            is_multi = trg.sum(dim=-1) > 1  # (B, S)
            pix_multi = is_multi.gather(1, spx.clamp(0, nseg - 1))
        mask = mask & pix_multi
    sid = torch.where(mask, spx, nseg).int()
    mx, present = _segment_max(probs, sid, nseg)
    entry = (trg > 0.5) & present[:, :, None]
    nll = -torch.log(mx + EPS)
    return _norm(_where_sum(entry, nll), entry.sum())


def onehot_ce_multihot_choice(logits, targets, spx, spmask, *, temp=1.0,
                              return_multi_mask=False):
    """Loss decomposition of the merged-positive CE (partial.py:110-136):
    a plain CE over pixels of one-hot superpixels, the merged-positive
    term over multi-hot ones, each with its own normaliser; all C + 1
    target channels. Returns (oh_loss, mh_loss[, per-pixel multi mask])."""
    probs, trg, spx, mask = _flatten(logits, targets, spx, spmask, temp,
                                     slice_last=False)
    trg_pixel = _pixel_targets(trg, spx)
    n_cand = trg_pixel.sum(dim=1)
    nll = -torch.log((probs * trg_pixel).sum(dim=1) + EPS)
    oh = mask & (n_cand == 1)
    mh = mask & (n_cand > 1)
    oh_loss = _norm(_where_sum(oh, nll), oh.sum())
    mh_loss = _norm(_where_sum(mh, nll), mh.sum())
    if return_multi_mask:
        return oh_loss, mh_loss, n_cand > 1
    return oh_loss, mh_loss


def lossdecomp(logits, targets, spx, spmask, *, nseg, coeff=16.0,
               coeff_mc=8.0, coeff_gm=1.0, multi_ce_temp=0.1,
               group_ce_temp=0.1):
    """The unfused stage-1 loss (partial.py:139-171), the fallback for a
    batch without target bits: coeff*CE(one-hot) + coeff_mc*MC(multi-hot)
    + coeff_gm*Group(multi-hot). The CE term uses multi_ce_temp, as the
    reference does. Returns (total, aux)."""
    ce, mc, pix_multi = onehot_ce_multihot_choice(
        logits, targets, spx, spmask, temp=multi_ce_temp,
        return_multi_mask=True)
    group = group_multi_label_ce(logits, targets, spx, spmask, nseg=nseg,
                                 temp=group_ce_temp, slice_last=False,
                                 only_multi=True, pixel_multi_mask=pix_multi)
    total = coeff * ce + coeff_mc * mc + coeff_gm * group
    return total, {"ce_loss": ce, "mc_loss": mc, "group_loss": group,
                   "train_loss": total}


def multi_choice_ce_scale(logits, targets, spx, spmask, *, temp=1.0):
    """MC loss with each pixel's NLL scaled by log(C)/log(max(C + 1 -
    nhot, 2)) (partial.py:174-194)."""
    probs, trg, spx, mask = _flatten(logits, targets, spx, spmask, temp,
                                     slice_last=False)
    C = probs.shape[1]
    ks = torch.arange(C, dtype=torch.float32, device=probs.device)
    table = torch.log(torch.tensor(float(C), device=probs.device)) / \
        torch.log(torch.clamp(C - ks, min=2.0))
    trg_pixel = _pixel_targets(trg, spx)
    valid = mask & (trg_pixel > 0).any(dim=1)
    pos = (probs * trg_pixel).sum(dim=1)
    nhot = trg_pixel.sum(dim=1).nan_to_num(0.0).int()
    w = table[torch.clamp(nhot - 1, 0, C - 1).long()]
    nll = -w * torch.log(pos + EPS)
    return _norm(_where_sum(valid, nll), valid.sum())


def multi_choice_ce_only_dominant(logits, targets, spx, spmask, *,
                                  temp=1.0):
    """MC loss restricted to pixels of one-hot superpixels
    (partial.py:197-210)."""
    probs, trg, spx, mask = _flatten(logits, targets, spx, spmask, temp,
                                     slice_last=False)
    trg_pixel = _pixel_targets(trg, spx)
    valid = mask & (trg_pixel.sum(dim=1) == 1)
    nll = -torch.log((probs * trg_pixel).sum(dim=1) + EPS)
    return _norm(_where_sum(valid, nll), valid.sum())


def weighted_group_multi_label_ce(logits, plbl_logits, targets, spx, spmask,
                                  *, nseg, temp=1.0, only_single=False):
    """Group entries weighted by the detached segment max of an eval-mode
    prediction's softmax (partial.py:213-236): two K5 launches an
    image."""
    probs, trg, spx, mask = _flatten(logits, targets, spx, spmask, temp,
                                     slice_last=False)
    plbl_probs = _softmax(plbl_logits.detach(), temp)
    row_ok = (trg.sum(dim=-1) > 1) if only_single else (trg > 0).any(dim=-1)
    sid = torch.where(mask, spx, nseg).int()
    mx, present = _segment_max(probs, sid, nseg)
    wmx = torch.stack([seg_max_fwd(plbl_probs[b].t(), sid[b].contiguous(),
                                   nseg)[0]
                       for b in range(probs.shape[0])])
    entry = (trg > 0.5) & present[:, :, None] & row_ok[:, :, None]
    nll = -wmx * torch.log(mx + EPS)
    return _norm(_where_sum(entry, nll), entry.sum())


def top_one_plbl_loss(logits, plbl_logits, targets, spx, spmask, *,
                      temp=1.0, within_filtering=False, threshold=0.0):
    """On multi-candidate pixels whose eval-view top candidate confidence
    (optionally renormalised within the candidates) passes the threshold,
    -log of the train view's top candidate probability
    (partial.py:239-262)."""
    probs, trg, spx, mask = _flatten(logits, targets, spx, spmask, temp,
                                     slice_last=False)
    plbl_probs = _softmax(plbl_logits.detach(), temp)
    trg_pixel = _pixel_targets(trg, spx)
    multi = mask & (trg_pixel.sum(dim=1) > 1)
    pos = probs * trg_pixel
    pos_plbl = plbl_probs * trg_pixel
    if within_filtering:
        pos_plbl = pos_plbl / torch.clamp(
            pos_plbl.sum(dim=1, keepdim=True), min=EPS)
    keep = multi & (pos_plbl.amax(dim=1) > threshold)
    top = pos.amax(dim=1)
    return _norm(_where_sum(keep, -torch.log(top + EPS)), keep.sum())


def exclusive_ce(logits, targets, spx, spmask):
    """For each candidate class, a softmax whose denominator leaves out
    the other candidates; the mean over candidates per pixel
    (partial.py:265-286). Raw logits, exponentiated with no max taken
    off, as the JAX package does."""
    B, C = logits.shape[:2]
    lg = logits.float().reshape(B, C, -1)
    spx = spx.reshape(B, -1).long()
    mask = spmask.reshape(B, -1).bool()
    trg_pixel = _pixel_targets(targets.float(), spx)
    valid = mask & (trg_pixel > 0).any(dim=1)
    e = torch.exp(lg)
    neg_sum = (e * (1.0 - trg_pixel)).sum(dim=1, keepdim=True)
    denom = (neg_sum + e) * trg_pixel
    es = (e * trg_pixel) / (denom + EPS)
    ce = -torch.log(es + EPS) * trg_pixel
    pix = ce.sum(dim=1) / torch.clamp(trg_pixel.sum(dim=1), min=1.0)
    return _norm(_where_sum(valid, pix), valid.sum())


def onehot_ce_multihot_topone(logits, targets, spx, spmask, *, temp=1.0):
    """Lossdecomp with the multi-hot term on -log(max candidate prob)
    (partial.py:289-309)."""
    probs, trg, spx, mask = _flatten(logits, targets, spx, spmask, temp,
                                     slice_last=False)
    trg_pixel = _pixel_targets(trg, spx)
    n_cand = trg_pixel.sum(dim=1)
    pos = probs * trg_pixel
    oh = mask & (n_cand == 1)
    mh = mask & (n_cand > 1)
    oh_loss = _norm(_where_sum(oh, -torch.log(pos.sum(dim=1) + EPS)),
                    oh.sum())
    mh_loss = _norm(_where_sum(mh, -torch.log(pos.amax(dim=1) + EPS)),
                    mh.sum())
    return oh_loss, mh_loss


def onehot_ce_multihot_rc(logits, targets, spx, spmask, *, temp=1.0):
    """Lossdecomp with risk-consistent weights on the multi-hot term: the
    per-class NLLs weighted by the self-normalised detached candidate
    predictions (partial.py:312-332)."""
    probs, trg, spx, mask = _flatten(logits, targets, spx, spmask, temp,
                                     slice_last=False)
    trg_pixel = _pixel_targets(trg, spx)
    n_cand = trg_pixel.sum(dim=1)
    pos = probs * trg_pixel
    oh = mask & (n_cand == 1)
    mh = mask & (n_cand > 1)
    oh_loss = _norm(_where_sum(oh, -torch.log(pos.sum(dim=1) + EPS)),
                    oh.sum())
    mh_loss = _norm(_where_sum(mh, _rc_per_pixel(pos)), mh.sum())
    return oh_loss, mh_loss


def _rc_per_pixel(pos):
    w = pos.detach()
    w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=EPS)
    return (w * -torch.log(pos + EPS)).sum(dim=1)


def rc_multi_choice_ce(logits, targets, spx, spmask, *, temp=1.0,
                       slice_last=True):
    """Risk-consistent weighted candidate CE (partial.py:335-348)."""
    probs, trg, spx, mask = _flatten(logits, targets, spx, spmask, temp,
                                     slice_last)
    trg_pixel = _pixel_targets(trg, spx)
    valid = mask & (trg_pixel > 0).any(dim=1)
    perpix = _rc_per_pixel(probs * trg_pixel)
    return _norm(_where_sum(valid, perpix), valid.sum())


def multi_choice_ent(logits, targets, spx, spmask, *, temp=1.0,
                     slice_last=True):
    """Entropy within the candidate set on multi-hot pixels
    (partial.py:351-368). The softmax runs over rows masked to -inf, so a
    pixel with no candidate gives NaN there, which the candidate mask then
    drops, as in the JAX package."""
    B, C = logits.shape[:2]
    lg = logits.float().reshape(B, C, -1)
    spx = spx.reshape(B, -1).long()
    mask = spmask.reshape(B, -1).bool()
    trg = targets[..., :-1] if slice_last else targets
    trg_pixel = _pixel_targets(trg.float(), spx)
    valid = mask & (trg_pixel.sum(dim=1) > 1)
    cand = trg_pixel > 0
    p = torch.softmax(torch.where(cand, lg, float("-inf")) / temp, dim=1)
    p = torch.where(cand, p, 0.0)
    ent = -(p * torch.log(p + EPS)).sum(dim=1)
    return _norm(_where_sum(valid, ent), valid.sum())


def max_multi_choice_ce(logits, targets, spx, spmask, *, temp=1.0,
                        slice_last=True):
    """CE on each pixel's most confident candidate class
    (partial.py:371-386, the JAX package's reconstruction)."""
    probs, trg, spx, mask = _flatten(logits, targets, spx, spmask, temp,
                                     slice_last)
    trg_pixel = _pixel_targets(trg, spx)
    valid = mask & (trg_pixel > 0).any(dim=1)
    pos = torch.where(trg_pixel > 0, probs, 0.0).amax(dim=1)
    return _norm(_where_sum(valid, -torch.log(pos + EPS)), valid.sum())


def rand_multi_choice_ce(logits, targets, spx, spmask, generator, *,
                         temp=1.0, slice_last=True):
    """CE on one candidate class per pixel drawn uniformly
    (partial.py:389-406, the JAX package's reconstruction): the argmax of
    independent uniform draws from `generator` (a torch.Generator on the
    logits' device) over the candidates. JAX draws Gumbel noise from its
    own key, so the classes picked differ; the distribution is the
    same. Under data parallelism every rank draws the global batch's
    uniforms and keeps its own rows (as models/layers.Dropout does), so
    the ranks pick the classes one rank picks."""
    probs, trg, spx, mask = _flatten(logits, targets, spx, spmask, temp,
                                     slice_last)
    trg_pixel = _pixel_targets(trg, spx)
    valid = mask & (trg_pixel > 0).any(dim=1)
    w = mesh.world()
    u = torch.rand((trg_pixel.shape[0] * w,) + trg_pixel.shape[1:],
                   generator=generator, device=trg_pixel.device)
    if w > 1:
        u = u[mesh.local_rows(u.shape[0])]
    pick = torch.where(trg_pixel > 0, u, -1.0).argmax(dim=1)
    pos = probs.gather(1, pick[:, None])[:, 0]
    return _norm(_where_sum(valid, -torch.log(pos + EPS)), valid.sum())


def plbl_onehot_ce_multihot_choice(logits, targets, spx, spmask, plbl, *,
                                   temp=1.0, ignore_idx=255):
    """The sequence trainer's positive term (partial.py:409-455): CE on
    one-hot pixels and on multi-hot pixels whose previous-round pseudo
    label is a candidate (that class), merged-positive MC on the other
    multi-hot pixels. Returns (ce_sum, ce_num, mc_sum, mc_num): the sums
    this rank's, the counts the global batch's (float64, parallel/mesh.
    global_count), which the caller's one normaliser adds."""
    probs, trg, spx_f, mask = _flatten(logits, targets, spx, spmask, temp,
                                       slice_last=False)
    B, C, P = probs.shape
    trg_pixel = _pixel_targets(trg, spx_f)
    n_cand = trg_pixel.sum(dim=1)
    plbl = plbl.reshape(B, P).long()
    plbl_safe = plbl.clamp(0, C - 1)
    plbl_in_cand = (plbl != ignore_idx) & (
        trg_pixel.gather(1, plbl_safe[:, None])[:, 0] > 0)
    pos_merged = (probs * trg_pixel).sum(dim=1)
    pos_plbl = probs.gather(1, plbl_safe[:, None])[:, 0]
    oh = mask & (n_cand == 1)
    mh_plbl = mask & (n_cand > 1) & plbl_in_cand
    mh = mask & (n_cand > 1) & ~plbl_in_cand
    ce_sum = (_where_sum(oh, -torch.log(pos_merged + EPS))
              + _where_sum(mh_plbl, -torch.log(pos_plbl + EPS)))
    mc_sum = _where_sum(mh, -torch.log(pos_merged + EPS))
    ce_num, mc_num = mesh.global_count(torch.stack(
        [oh.sum() + mh_plbl.sum(), mh.sum()]))
    return ce_sum, ce_num, mc_sum, mc_num
