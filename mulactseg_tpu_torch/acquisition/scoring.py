"""Acquisition scoring on NCHW logits: the port of
mulactseg_tpu/acquisition/scoring.py.

BvSB per pixel (p2 / p1 + 1e-8), optional class-balance weighting by the
top-1 class, per-superpixel means and per-superpixel top-1 votes, then
min-max normalisation and the ban of regions whose vote is the undefined
channel. Segment sums and counts are index_add_ / scatter_add_ into
nseg + 1 bins per image (ids >= nseg fall in the last, dropped bin), so a
region with no pixel gets exactly 0.0, which minmax_normalize leaves out.

Top-1 is torch.argmax (the first maximum on the CPU and on the card, as
lax.top_k) and the runner-up the max with that one entry masked, so on a
tie p2 == p1 as in the JAX package; torch.topk's order on ties is not
specified.
"""

from __future__ import annotations

import torch


def bvsb_top1(logits: torch.Tensor, temp: float):
    """(B, C, H, W) -> bvsb (B, H, W) float32, top1 (B, H, W) int64."""
    prob = torch.softmax(logits.float() / temp, dim=1)
    top1 = prob.argmax(dim=1)
    p1 = prob.gather(1, top1[:, None])
    p2 = prob.scatter(1, top1[:, None], float("-inf")).amax(dim=1)
    return p2 / p1[:, 0] + 1e-8, top1


def _bins(spx: torch.Tensor, nseg: int) -> torch.Tensor:
    """(B, H, W) ids -> (B * HW,) bin of each pixel: b * (nseg + 1) + id,
    with ids outside [0, nseg) in each image's last bin."""
    B = spx.shape[0]
    s = spx.reshape(B, -1).long()
    s = torch.where((s >= 0) & (s < nseg), s, nseg)
    off = torch.arange(B, device=s.device)[:, None] * (nseg + 1)
    return (s + off).reshape(-1)


def _seg_mean(values: torch.Tensor, bins: torch.Tensor, B: int, nseg: int):
    """(B, ...) pixel values -> (B, nseg) per-segment mean, 0.0 where a
    segment has no pixel."""
    n = B * (nseg + 1)
    v = values.reshape(-1).float()
    s = torch.zeros(n, dtype=torch.float32, device=v.device).index_add_(
        0, bins, v)
    c = torch.zeros(n, dtype=torch.int64, device=v.device).scatter_add_(
        0, bins, torch.ones_like(bins))
    mean = torch.where(c > 0, s / c.clamp(min=1).float(),
                       torch.zeros_like(s))
    return mean.view(B, nseg + 1)[:, :nseg]


def region_bvsb_scores(logits, spx, *, nseg: int, temp: float,
                       drop_last: bool = False):
    """Plain BvSB region scores: the per-superpixel mean of pixel BvSB.
    drop_last slices off the undefined channel (predignore models).
    Returns (B, nseg) float32."""
    if drop_last:
        logits = logits[:, :-1]
    bvsb, _ = bvsb_top1(logits, temp)
    return _seg_mean(bvsb, _bins(spx, nseg), logits.shape[0], nseg)


def mean_softmax(logits, temp):
    """Pass 1 of the paper selector: the mean softmax over the batch's
    pixels, (C,); the caller sums the batches' and divides by their
    number."""
    prob = torch.softmax(logits.float() / temp, dim=1)
    return prob.mean(dim=(0, 2, 3))


def cls_weight_pwr(cumulated_prob, coeff):
    """(k * p_hat + 1) ^ -2."""
    return (coeff * cumulated_prob + 1.0) ** -2


def region_weighted_bvsb_and_votes(logits, spx, cls_weight, *, nseg: int,
                                   temp: float = 1.0):
    """Pass 2: pixel BvSB over all channels weighted by the top-1 class's
    weight, region means; plus per-region top-1 vote counts. Returns
    (B, nseg) float32 scores and (B, nseg, C) int32 votes."""
    B, C = logits.shape[:2]
    bvsb, top1 = bvsb_top1(logits, temp)
    weighted = bvsb * cls_weight.to(bvsb.device).float()[top1]
    bins = _bins(spx, nseg)
    mean = _seg_mean(weighted, bins, B, nseg)
    votes = torch.zeros(B * (nseg + 1) * C, dtype=torch.int64,
                        device=logits.device).scatter_add_(
        0, bins * C + top1.reshape(-1), torch.ones_like(bins))
    votes = votes.view(B, nseg + 1, C)[:, :nseg].int()
    return mean, votes


def minmax_normalize(scores):
    """Normalise over the whole tensor, leaving out exact zeros (absent
    regions): valid scores map to [0, 1], absent regions go negative."""
    flat = scores.reshape(-1)
    big = torch.where(flat != 0, flat, torch.full_like(flat, float("inf")))
    shifted = flat - big.min()
    mx = shifted.max()
    return (shifted / torch.where(mx == 0, torch.ones_like(mx), mx)
            ).reshape(scores.shape)


def ban_ignore_dominant(scores, votes):
    """Zero the score of regions whose top-1-vote class is the undefined
    (last) channel; argmax takes the first of tied counts."""
    dom = votes.argmax(dim=-1)
    return torch.where(dom == votes.shape[-1] - 1,
                       torch.zeros_like(scores), scores)
