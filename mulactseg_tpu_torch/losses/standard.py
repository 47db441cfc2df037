"""Dense-label losses: the port of mulactseg_tpu/losses/standard.py, on
float32 NCHW logits: temperature CE (stage-2 retraining), focal loss and
the RCCE variants over dense candidate maps. Under data parallelism each
mean's count is the global batch's, so each rank returns its share of
the global mean."""

from __future__ import annotations

import torch

from mulactseg_tpu_torch.parallel import mesh

EPS = 1e-8


def _count(mask):
    """The global batch's count of mask, at least 1 (a mean's
    denominator; parallel/mesh.global_count)."""
    return mesh.global_count(mask.sum()).clamp(min=1).float()


def cross_entropy(logits, labels, *, temp=1.0, ignore_index=255):
    """Mean CE over non-ignored pixels with temperature, in float32.
    logits (B, C, H, W) float, labels (B, H, W) int."""
    lg = logits.float() / temp
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(lg, dim=1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    loss = torch.where(valid, nll, torch.zeros_like(nll)).sum()
    return loss / _count(valid)


def focal_loss(logits, labels, *, alpha=1.0, gamma=0.0, ignore_index=255,
               size_average=True):
    """alpha * (1 - p_t)^gamma * CE per non-ignored pixel (standard.py:
    30-41): the mean over them, or the sum."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=1)
    ce = -logp.gather(1, safe[:, None])[:, 0]
    pt = torch.exp(-ce)
    fl = torch.where(valid, alpha * (1.0 - pt) ** gamma * ce, 0.0)
    if size_average:
        return fl.sum() / _count(valid)
    return fl.sum()


def _rc_core(probs, probs_w, trg):
    """probs / probs_w / trg (C, N), trg in {0, 1}: -log of the candidate
    probabilities summed under self-normalised detached weights."""
    w = (probs_w * trg).detach()
    w = w / torch.clamp(w.sum(dim=0, keepdim=True), min=EPS)
    return -torch.log((w * probs * trg).sum(dim=0) + EPS)


def _class_major(x):
    """(B, C, H, W) -> (C, B * H * W)."""
    return x.transpose(0, 1).reshape(x.shape[1], -1)


def rcce(logits, targets, *, temp=1.0):
    """RCCE over dense candidate maps (standard.py:53-64): targets
    (B, C + 1, H, W), the last channel the ignore flag."""
    p = torch.softmax(_class_major(logits.float()) / temp, dim=0)
    t = _class_major(targets.float())
    keep = t[-1] == 0
    loss = torch.where(keep, _rc_core(p, p, t[:-1]), 0.0)
    return loss.sum() / _count(keep)


def rcce_asym(logits, logits_w, targets, *, temp=1.0, temp_w=1.0):
    """Asymmetric RCCE (standard.py:67-77): the weights from a second
    (weak-view) prediction."""
    p = torch.softmax(_class_major(logits.float()) / temp, dim=0)
    pw = torch.softmax(_class_major(logits_w.float()) / temp_w, dim=0)
    t = _class_major(targets.float())
    keep = t[-1] == 0
    loss = torch.where(keep, _rc_core(p, pw, t[:-1]), 0.0)
    return loss.sum() / _count(keep)
