"""Online prototype pseudo labels and prototype-weighted CE: the port of
mulactseg_tpu/losses/online.py (local_proto_plbl :36-93,
prototype_weight_targets :96-146, prototype_weighted_ce :149-165,
local_proto_ce :167-179).

Per image, an eval-mode forward's softmax gives each (multi-hot
superpixel, candidate class) pair a prototype, its argmax pixel (kernel
K5 on the card). The online criteria give each valid pixel of a multi-hot
superpixel the class of its most similar (cosine) prototype of its own
superpixel (local_proto_plbl) and add a CE against these labels
(local_proto_ce); pwce weights each candidate class by the softmax of
the pixel's similarities to its superpixel's prototypes
(prototype_weight_targets). At most `max_protos` prototypes are kept:
the first ones in (superpixel, class) row-major order, the others
dropped, as jnp.nonzero(..., size=max_protos) drops them. The compaction
is a cumsum and a scatter, so the card is not synchronised.

Under data parallelism the prototypes and their cap stay per image, as
the JAX package vmaps them; the two losses' counts and pwce's finiteness
test are the global batch's (parallel/mesh.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mulactseg_tpu_torch.ops.segment_max import seg_max_fwd
from mulactseg_tpu_torch.parallel import mesh

EPS = 1e-8
NEG = -1e30


class Prototypes(NamedTuple):
    """One image's prototype slots. valid (P,): pixels of a selected
    multi-hot superpixel; spx (P,) long; sid (NP,) each slot's superpixel
    (nseg when empty); cls (NP,) its class; ok (NP,) the slot is filled;
    src (NP,) its source pixel; feats (NP, Ch) float32 features of the
    source pixels (0 in empty slots); candidates: 0-d count of the image's
    (superpixel, class) pairs, of which the first NP fill the slots."""
    valid: torch.Tensor
    spx: torch.Tensor
    sid: torch.Tensor
    cls: torch.Tensor
    ok: torch.Tensor
    src: torch.Tensor
    feats: torch.Tensor
    candidates: torch.Tensor


def prototypes(feats, probs, targets, spx, spmask, *, nseg, max_protos=256):
    """The prototype compaction the online criteria and pwce share
    (online.py:50-65 and :117-132): K5 over the multi-hot superpixels'
    pixels, the existing (superpixel, class) pairs in row-major order, the
    first max_protos of them kept. feats (P, Ch) (any strides), probs
    (P, C), targets (S, C), spx and spmask (P,)."""
    P = feats.shape[0]
    C = probs.shape[-1]
    dev = feats.device
    spx = spx.reshape(P).long()
    is_multi = targets.sum(dim=-1) > 1
    valid = spmask.reshape(P).bool() & is_multi[spx.clamp(0, nseg - 1)]
    sid = torch.where(valid, spx, nseg).int()
    _, argpix = seg_max_fwd(probs.float(), sid, nseg)

    exists = ((targets > 0.5) & (argpix < P) & is_multi[:, None]).reshape(-1)
    rank = exists.long().cumsum(0) - 1
    slot = torch.where(exists & (rank < max_protos), rank, max_protos)
    flat_idx = torch.full((max_protos + 1,), nseg * C, device=dev,
                          dtype=torch.long).scatter_(
        0, slot, torch.arange(nseg * C, device=dev))[:max_protos]
    ok = flat_idx < nseg * C
    src = argpix.reshape(-1)[flat_idx.clamp(max=nseg * C - 1)].long()
    pf = feats.float()[src.clamp(0, P - 1)]
    return Prototypes(valid, spx, torch.where(ok, flat_idx // C, nseg),
                      flat_idx % C, ok, src,
                      torch.where(ok[:, None], pf, 0.0), exists.sum())


def _own_similarities(feats, protos, start, chunk):
    """(T, NP) cosine similarities of pixels [start, start + T) to the
    prototypes, and the mask of their own superpixel's filled slots."""
    cf = feats[start:start + chunk].float()
    own = (protos.sid[None, :] == protos.spx[start:start + chunk, None]) \
        & protos.ok[None, :]
    return cf @ protos.feats.t(), own


def local_proto_plbl(feats, probs, targets, spx, spmask, *, nseg,
                     max_protos=256, chunk=65536, ignore_value=255):
    """Per-image online pseudo labels (online.py:36-93). feats (P, Ch)
    normalised features (any strides), probs (P, C), targets (S, C), spx
    and spmask (P,) -> (plbl (P,) long, ignore_value outside the selected
    multi-hot superpixels; sim (P,) the cosine similarity to the assigned
    prototype, 0 where unassigned; is_proto_src (P,) bool, the prototypes'
    source pixels). Among equal similarities the first slot wins, as
    jnp.argmax picks."""
    P = feats.shape[0]
    pr = prototypes(feats, probs, targets, spx, spmask, nseg=nseg,
                    max_protos=max_protos)
    cls, best = [], []
    for start in range(0, P, chunk):
        sim, own = _own_similarities(feats, pr, start, chunk)
        b, j = torch.where(own, sim, NEG).max(dim=-1)
        cls.append(pr.cls[j])
        best.append(b)
    cls, best = torch.cat(cls), torch.cat(best)
    has = pr.valid & (best > NEG / 2)
    plbl = torch.where(has, cls, ignore_value)
    is_src = torch.zeros(P + 1, dtype=torch.bool, device=feats.device)
    is_src[torch.where(pr.ok, pr.src, P)] = True
    return plbl, torch.where(has, best, 0.0), is_src[:P]


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
    targets = targets.float()
    pr = prototypes(feats, probs_plbl, targets, spx, spmask, nseg=nseg,
                    max_protos=max_protos)
    trg_pixel = targets[pr.spx.clamp(0, nseg - 1)]
    oh_cls = torch.nn.functional.one_hot(pr.cls, C).float()  # (NP, C)
    wcls = []
    for start in range(0, P, chunk):
        sim, own = _own_similarities(feats, pr, start, chunk)
        s = torch.where(own, sim / simw_temp, NEG)
        w = torch.where(own, torch.softmax(s, dim=-1), 0.0)
        wcls.append(w @ oh_cls)  # prototype weights onto their classes
    wcls = torch.cat(wcls)
    return torch.where(pr.valid[:, None], wcls * trg_pixel,
                       trg_pixel).detach()


def prototype_weighted_ce(logits, weights, spmask, *, temp=1.0):
    """The pwce loss body (online.py:149-165): over spmask pixels, the sum
    of sum_c w_{p,c} * -log softmax_c, over 1 + their count; 0 where that
    is not finite (the global batch's loss, under data parallelism).
    logits (B, C, H, W), weights (B, H * W, C)."""
    B, C = logits.shape[:2]
    probs = torch.softmax(logits.float().reshape(B, C, -1) / temp, dim=1)
    m = spmask.reshape(B, -1).bool()
    nll = -torch.log(probs + EPS)
    per_pix = (weights.reshape(B, -1, C).transpose(1, 2) * nll).sum(dim=1)
    out = torch.where(m, per_pix, 0.0).sum() / (
        1.0 + mesh.global_count(m.sum())).to(per_pix.dtype)
    return torch.where(mesh.global_isfinite(out), out, 0.0)


def local_proto_ce(logits, plbl, *, temp=1.0, ignore_value=255,
                   weights=None):
    """CE between logits (B, C, H, W) and online pseudo labels plbl
    (B, H, W), each pixel's NLL scaled by the detached `weights`
    (B, H, W) when given; the mean over the global batch's labelled
    pixels, 0 without one (online.py:167-179)."""
    B, C = logits.shape[:2]
    logp = torch.log_softmax(logits.float() / temp, dim=1)
    plbl = plbl.reshape(B, 1, *logits.shape[2:]).long()
    valid = plbl[:, 0] != ignore_value
    nll = -logp.gather(1, torch.where(plbl != ignore_value, plbl, 0))[:, 0]
    if weights is not None:
        nll = nll * weights.reshape(nll.shape).detach()
    n = mesh.global_count(valid.sum())
    loss = torch.where(valid, nll, 0.0).sum()
    return torch.where(n > 0, loss / n.clamp(min=1).to(loss.dtype), 0.0)
