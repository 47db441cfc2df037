"""The plain reference of the recipe's training step: the stage-1 lossdecomp
(one-hot CE, multi-hot multiple-choice CE, the per-segment group term),
AdamW with the poly schedule, in float32 plain
torch, written from the recipe's definitions (the reference's
trainer/active_joint_multi_predignore_lossdecomp.py and the optax AdamW it
runs with). It reads only what the benchmark made: weights, batches, the
dropout seed and the recipe's settings.
"""

from __future__ import annotations

from typing import Dict, List

import torch

EPS = 1e-8


def candidates(bits, C):
    """(B, H, W) int32 bitmasks -> (B, C, H, W) float 0/1 of the low C
    bits, and the candidate count per pixel."""
    shifts = torch.arange(C, device=bits.device, dtype=torch.int32)
    t = ((bits.int()[:, None] >> shifts[None, :, None, None]) & 1).float()
    return t, t.sum(1)


def lossdecomp(logits, bits, target, spx, s: Dict):
    """coeff * CE(one-hot pixels) + coeff_mc * MC(multi-hot pixels)
    + coeff_gm * group(multi-hot segments), each over 1 + its count."""
    B, C, H, W = logits.shape
    nseg = target.shape[1]
    t, n = candidates(bits, C)
    p = torch.softmax(logits / s["multi_ce_temp"], dim=1)
    nll = -torch.log((p * t).sum(1) + EPS)
    one, multi = n == 1, n > 1
    ce = torch.where(one, nll, 0.0).sum() / (1.0 + one.sum())
    mc = torch.where(multi, nll, 0.0).sum() / (1.0 + multi.sum())
    # group: per (segment, class), the largest probability among the
    # segment's multi-hot pixels, for each class annotated there
    pg = torch.softmax(logits / s["group_ce_temp"], dim=1)
    off = torch.arange(B, device=spx.device)[:, None, None] * nseg
    sid = torch.where(multi, spx.long() + off, B * nseg).reshape(-1)
    rows = pg.permute(0, 2, 3, 1).reshape(-1, C)
    mx = torch.zeros(B * nseg + 1, C, device=logits.device).scatter_reduce(
        0, sid[:, None].expand(-1, C), rows, "amax", include_self=False)
    present = torch.zeros(B * nseg + 1, dtype=torch.bool,
                          device=logits.device)
    present[sid] = True
    mx, present = mx[:-1].reshape(B, nseg, C), present[:-1].reshape(B, nseg)
    entry = (target[..., :C] > 0.5) & present[..., None]
    group = torch.where(entry, -torch.log(mx + EPS), 0.0).sum() \
        / (1.0 + entry.sum())
    return s["coeff"] * ce + s["coeff_mc"] * mc + s["coeff_gm"] * group


def poly_lr(base, step, s):
    frac = max(1.0 - step / s["finetune_itrs"], 0.0)
    return max(base * frac ** s["power"], s["min_lr"])


class AdamW:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8, decay on every parameter), the
    head (`classifier.`) at cls_lr_scale times the LR, the poly schedule
    read at the step count before the update (the first update's count is
    `start`)."""

    def __init__(self, named_params, s: Dict, start: int = 0):
        self.s, self.start = s, start
        self.params = list(named_params)
        self.m = [torch.zeros_like(p) for _, p in self.params]
        self.v = [torch.zeros_like(p) for _, p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        s, self.t = self.s, self.t + 1
        b1, b2 = 0.9, 0.999
        for (name, p), m, v in zip(self.params, self.m, self.v):
            base = s["train_lr"] * (s["cls_lr_scale"]
                                    if name.startswith("classifier.") else 1)
            lr = poly_lr(base, self.start + self.t - 1, s)
            g = p.grad
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            mhat = m / (1 - b1 ** self.t)
            vhat = v / (1 - b2 ** self.t)
            p.mul_(1 - lr * s["weight_decay"])
            p.sub_(lr * mhat / (torch.sqrt(vhat) + 1e-8))


def loss_of(net, batch, settings, stage, dev):
    if stage != "stage1":
        raise ValueError(f"no reference for {stage!r}")
    logits = net(torch.as_tensor(batch["images"]).to(dev))
    return lossdecomp(logits, torch.as_tensor(batch["target_bits"]).to(dev),
                      torch.as_tensor(batch["target"]).to(dev),
                      torch.as_tensor(batch["spx"]).to(dev), settings)


def run_steps(net, batches: List[Dict], settings: Dict, stage: str, dev):
    """Train `net` (train mode) one step a batch. Returns the loss of each
    step, the norm of each leaf's first gradient (by name) and the first
    gradients themselves; the weights are left as the steps make them."""
    net.train()
    opt = AdamW(net.named_parameters(), settings)
    losses, first = [], None
    for batch in batches:
        for _, p in opt.params:
            p.grad = None
        loss = loss_of(net, batch, settings, stage, dev)
        loss.backward()
        if first is None:
            first = [p.grad.detach().clone() for _, p in opt.params]
        opt.step()
        losses.append(float(loss.detach()))
    norms = {n: float(g.norm()) for (n, _), g in zip(opt.params, first)}
    return losses, norms, first
