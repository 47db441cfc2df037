"""Prototype-weighted CE (the pwce criterion): the port of
prototype_weight_targets and prototype_weighted_ce in
mulactseg_tpu/losses/online.py:96-165.

Per image, an eval-mode forward's softmax gives each (multi-hot
superpixel, candidate class) pair a prototype, its argmax pixel (kernel
K5 on the card); a pixel of a multi-hot superpixel weights each candidate
class by the softmax, over its own superpixel's prototypes, of its cosine
similarity to them. At most `max_protos` prototypes are kept: the first
ones in (superpixel, class) row-major order, the others dropped, as
jnp.nonzero(..., size=max_protos) drops them. The compaction is a cumsum
and a scatter, so the card is not synchronised.
"""

from __future__ import annotations

import torch

from mulactseg_tpu_torch.ops.segment_max import seg_max_fwd

EPS = 1e-8
NEG = -1e30


def prototype_weight_targets(feats, probs_plbl, targets, spx, spmask, *,
                             nseg, simw_temp=1.0, max_protos=256,
                             chunk=65536):
    """feats (P, Ch) normalised features (any strides, e.g. an NCHW
    image's planes through .t()), probs_plbl (P, C), targets (S, C), spx
    and spmask (P,) -> (P, C) detached weights: each candidate entry of a
    valid multi-hot pixel's target row scaled by its prototype weight,
    the other rows the target row itself."""
    P = feats.shape[0]
    C = probs_plbl.shape[-1]
    dev = feats.device
    spx = spx.reshape(P).long()
    spmask = spmask.reshape(P).bool()
    spx_c = spx.clamp(0, nseg - 1)
    targets = targets.float()
    trg_pixel = targets[spx_c]
    is_multi_row = targets.sum(dim=-1) > 1
    valid = spmask & is_multi_row[spx_c]
    sid = torch.where(valid, spx, nseg).int()
    _, argpix = seg_max_fwd(probs_plbl.float(), sid, nseg)

    exists = ((targets > 0.5) & (argpix < P)
              & is_multi_row[:, None]).reshape(-1)
    rank = exists.long().cumsum(0) - 1
    slot = torch.where(exists & (rank < max_protos), rank, max_protos)
    flat_idx = torch.full((max_protos + 1,), nseg * C, device=dev,
                          dtype=torch.long).scatter_(
        0, slot, torch.arange(nseg * C, device=dev))[:max_protos]
    proto_ok = flat_idx < nseg * C
    proto_sid = torch.where(proto_ok, flat_idx // C, nseg)
    proto_cls = flat_idx % C
    src = argpix.reshape(-1)[flat_idx.clamp(max=nseg * C - 1)].long()
    pf = feats.float()[src.clamp(0, P - 1)]
    pf = torch.where(proto_ok[:, None], pf, 0.0)  # (NP, Ch)
    oh_cls = torch.nn.functional.one_hot(proto_cls, C).float()  # (NP, C)

    wcls = []
    for start in range(0, P, chunk):
        cf = feats[start:start + chunk].float()
        own = (proto_sid[None, :] == spx[start:start + chunk, None]) \
            & proto_ok[None, :]
        s = torch.where(own, (cf @ pf.t()) / simw_temp, NEG)
        w = torch.where(own, torch.softmax(s, dim=-1), 0.0)
        wcls.append(w @ oh_cls)  # prototype weights onto their classes
    wcls = torch.cat(wcls)
    return torch.where(valid[:, None], wcls * trg_pixel, trg_pixel).detach()


def prototype_weighted_ce(logits, weights, spmask, *, temp=1.0):
    """The pwce loss body (online.py:149-165): over spmask pixels, the sum
    of sum_c w_{p,c} * -log softmax_c, over 1 + their count; 0 where that
    is not finite. logits (B, C, H, W), weights (B, H * W, C)."""
    B, C = logits.shape[:2]
    probs = torch.softmax(logits.float().reshape(B, C, -1) / temp, dim=1)
    m = spmask.reshape(B, -1).bool()
    nll = -torch.log(probs + EPS)
    per_pix = (weights.reshape(B, -1, C).transpose(1, 2) * nll).sum(dim=1)
    out = torch.where(m, per_pix, 0.0).sum() / (1.0 + m.sum())
    return torch.where(torch.isfinite(out), out, 0.0)
