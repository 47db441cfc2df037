"""Cosine-prototype pseudo labels with neighbourhood propagation: the port
of mulactseg_tpu/plbl/cosine_prop.py.

For one image (reference trainer/eval_save_cosplbl_prop.py:121-313):
  1. per-(superpixel, class) argmax pixels (K5, ops/segment_max.py) give
     one prototype feature per annotated class of each selected
     superpixel, in a fixed (NP,) slot table ordered by (spx, class);
  2. a chunked (pixels x prototypes) cosine-similarity product assigns
     each valid pixel its nearest prototype of its own superpixel;
  3. per-prototype lower-median (or min) thresholds of those similarities;
  4. propagation: every pixel takes the highest-id adjacent selected
     superpixel with a prototype above its threshold, and that
     superpixel's most similar prototype's class;
  5. within-superpixel assignments overwrite propagated ones.
The similarity products are plain matrix products (XLA dots in the JAX
package, torch.matmul here).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mulactseg_tpu_torch.ops.segment_max import segment_max_grad
from mulactseg_tpu_torch.utils.spans import span

NEG = -1e30


def selected_spx_adjacency(spx_map: np.ndarray, selected_ids, nseg: int,
                           targets: np.ndarray, max_protos: int,
                           include_onehot: bool) -> Tuple[np.ndarray, ...]:
    """Host-side prototype table + adjacency (the JAX package's numpy
    function, copied).

    spx_map: (H, W) int; selected_ids: iterable of selected spx ids;
    targets: (S, C) multi-hot. Returns
      proto_sid (NP,), proto_cls (NP,), proto_valid (NP,),
      proto_adj (NP, S) bool  -- adjacency row of each prototype's owner
                                 (3x3 dilation reach, includes itself).
    """
    S, C = targets.shape
    sel = np.zeros(S, bool)
    sel[np.asarray(list(selected_ids), dtype=np.int64)] = True
    use = targets > 0
    if not include_onehot:
        use &= (targets.sum(1) > 1)[:, None]
    use &= sel[:, None]
    sid, cls = np.nonzero(use)
    if len(sid) > max_protos:
        sid, cls = sid[:max_protos], cls[:max_protos]
    NP = max_protos
    proto_sid = np.full(NP, S, np.int32)
    proto_cls = np.zeros(NP, np.int32)
    proto_valid = np.zeros(NP, bool)
    proto_sid[:len(sid)] = sid
    proto_cls[:len(cls)] = cls
    proto_valid[:len(sid)] = True

    # adjacency is symmetric and reflexive, so 4 of the 8 shift directions
    # plus a transpose cover all pairs, and only pixels where the two ids
    # differ carry information
    adjp = np.zeros((S + 1, S + 1), bool)  # row/col S = out-of-range sink
    m = np.minimum(spx_map, S)
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        a = m[max(0, dy):m.shape[0] + min(0, dy),
              max(0, dx):m.shape[1] + min(0, dx)].reshape(-1)
        b = m[max(0, -dy):m.shape[0] + min(0, -dy),
              max(0, -dx):m.shape[1] + min(0, -dx)].reshape(-1)
        d = a != b
        adjp[a[d], b[d]] = True
    adj = adjp[:S, :S]
    adj |= adj.T
    np.fill_diagonal(adj, True)  # 3x3 dilation reach includes itself
    proto_adj = np.zeros((NP, S), bool)
    proto_adj[:len(sid)] = adj[sid]
    return proto_sid, proto_cls, proto_valid, proto_adj


def cosine_prototype_plbl(feats, probs, spx, pixel_valid, proto_sid,
                          proto_cls, proto_valid, proto_adj, *, nseg: int,
                          threshold_median: bool = True, chunk: int = 65536,
                          ignore_value: int = 255, propagate: bool = True,
                          filter_within_by_pred: bool = False,
                          filter_prop_by_pred: bool = False,
                          sim_bf16: bool = False) -> torch.Tensor:
    """Single-image pseudo-label map. Every tensor lies on one device.

    feats (P, Ch) L2-normalised, float32 or bfloat16, any strides (the
    (Ch, P) planes of the model's NCHW output as `.view(Ch, P).t()` go in
    without a copy); probs (P, C) softmax, float32, any strides; spx (P,)
    int in [0, nseg); pixel_valid (P,) bool (spmask, already restricted to
    multi-hot superpixels unless include_onehot); proto_* from
    selected_spx_adjacency, as tensors. Returns (P,) int32 labels with
    `ignore_value` where unassigned.

    sim_bf16: the similarities are products of bfloat16-rounded features
    and prototypes, summed in float32 (JAX's bf16 dot with a float32
    result). The operands are rounded to bfloat16 and multiplied in
    float32: a product of two bfloat16 values is exact in float32, so only
    the summation order differs from JAX.
    filter_within_by_pred: keep within-superpixel assignments only where
    the model's top-1 prediction agrees, except the prototype source
    pixels, which always take their prototype class (the highest class
    among a pixel's own prototypes, eval_save_cosplbl_filtgt.py:176-184).
    filter_prop_by_pred: keep propagated assignments only where the
    model's top-1 prediction agrees (eval_save_cosplbl_prop_filtered.py:
    303-305).
    """
    P, Ch = feats.shape
    dev = feats.device
    NP = proto_sid.shape[0]
    S = nseg
    spx = spx.int()
    proto_sid = proto_sid.long()
    proto_cls = proto_cls.long()

    sid = torch.where(pixel_valid, spx, S)
    with span("plbl.k5"):
        _, argpix = segment_max_grad(probs.float(), sid, S)
    src_pix = argpix[proto_sid.clamp(0, S - 1), proto_cls].long()
    proto_ok = proto_valid & (src_pix < P) & (proto_sid < S)
    pf = feats[src_pix.clamp(0, P - 1)].float()
    pf = torch.where(proto_ok[:, None], pf, 0.0)  # (NP, Ch)
    if sim_bf16:
        pf = pf.to(torch.bfloat16)
    pf_mm = pf.float().t()  # (Ch, NP)
    adj_t = proto_adj.t()  # (S, NP)

    def sim_of(lo, hi):
        cf = feats[lo:hi]
        if sim_bf16:
            cf = cf.to(torch.bfloat16)
        return torch.matmul(cf.float(), pf_mm)  # (T, NP)

    bounds = [(lo, min(lo + chunk, P)) for lo in range(0, P, chunk)]
    nn_proto = torch.empty(P, dtype=torch.long, device=dev)
    nn_sim = torch.empty(P, device=dev)
    with span("plbl.pass1"):
        for lo, hi in bounds:
            own = (proto_sid[None, :] == spx[lo:hi, None].long()) \
                & proto_ok[None, :]
            s_own = torch.where(own, sim_of(lo, hi), NEG)
            nn_sim[lo:hi] = s_own.amax(dim=-1)
            nn_proto[lo:hi] = s_own.argmax(dim=-1)

    with span("plbl.threshold"):
        assigned = pixel_valid & (nn_sim > NEG / 2)
        key = torch.where(assigned, nn_proto, NP)
        # (key, sim) order: a stable sort on sim, then a stable sort on the
        # key so permuted; only the sim values at each pick are read
        sim_sorted, order = torch.sort(nn_sim, stable=True)
        key_sorted, order2 = torch.sort(key[order], stable=True)
        sim_sorted = sim_sorted[order2]
        ends = torch.searchsorted(key_sorted,
                                  torch.arange(NP, device=dev), right=True)
        starts = torch.cat([ends.new_zeros(1), ends[:-1]])
        count = ends - starts
        if threshold_median:
            # torch.median = lower middle element
            # (eval_save_cosplbl_prop.py:247)
            pick = starts + (count - 1).clamp(min=0) // 2
        else:
            pick = starts
        thr = torch.where(count > 0, sim_sorted[pick.clamp(0, P - 1)], 1.0)
        pred_cls = probs.argmax(dim=-1)  # model top-1

    plbl = torch.full((P,), ignore_value, dtype=torch.long, device=dev)
    if propagate:
        with span("plbl.pass2"):
            for lo, hi in bounds:
                sim = sim_of(lo, hi)
                cand = adj_t[spx[lo:hi].long()] & proto_ok[None, :]
                passing = cand & (sim > thr[None, :])
                src = torch.where(passing, proto_sid[None, :], -1).amax(-1)
                has = src >= 0
                lbl_mask = cand & (proto_sid[None, :] == src[:, None])
                j = torch.where(lbl_mask, sim, NEG).argmax(dim=-1)
                lbl = proto_cls[j]
                if filter_prop_by_pred:
                    has = has & (lbl == pred_cls[lo:hi])
                plbl[lo:hi] = torch.where(has, lbl, ignore_value)
    within = proto_cls[nn_proto]
    if filter_within_by_pred:
        # prototype source pixels always keep their class (highest wins)
        proto_lbl = torch.full((P + 1,), -1, dtype=torch.long, device=dev)
        proto_lbl.scatter_reduce_(0, torch.where(proto_ok, src_pix, P),
                                  proto_cls, "amax")
        proto_lbl = proto_lbl[:P]
        within = torch.where(proto_lbl >= 0, proto_lbl, within)
        assigned = assigned & ((pred_cls == within) | (proto_lbl >= 0))
    return torch.where(assigned, within, plbl).int()
