"""Dense-label temperature cross-entropy (stage-2 retraining): the port of
cross_entropy in mulactseg_tpu/losses/standard.py:16.

The rest of that module (focal loss, the RCCE variants) belongs to the
criteria not ported yet (ROADMAP.md queue A, item 14).
"""

from __future__ import annotations

import torch


def cross_entropy(logits, labels, *, temp=1.0, ignore_index=255):
    """Mean CE over non-ignored pixels with temperature, in float32.
    logits (B, C, H, W) float, labels (B, H, W) int."""
    lg = logits.float() / temp
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(lg, dim=1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    loss = torch.where(valid, nll, torch.zeros_like(nll)).sum()
    n = valid.sum().clamp(min=1)
    return loss / n
