"""The plain reference of the recipe's pseudo-labeller
(`cosprop_includeonehot`, the reference's
trainer/eval_save_cosplbl_prop_includeonehot.py), in float32 plain torch
and numpy, for one full-resolution image:

1. each annotated class of each selected superpixel gets one prototype:
   the feature at the superpixel's pixel of highest softmax probability for
   that class (the first such pixel on ties), in (superpixel, class) order,
   at most `max_protos`;
2. each selected pixel takes the class of its most similar (cosine)
   prototype of its own superpixel;
3. each prototype's threshold is the lower median of the similarities of
   the pixels that took it;
4. every pixel takes, among the prototypes of the selected superpixels
   adjacent to its own (3x3 reach, its own included), those above their
   threshold; of the one with the highest superpixel id, the class of the
   most similar prototype there; else 255;
5. step 2's labels overwrite step 4's.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -1e30


def adjacency(spx: np.ndarray, S: int) -> np.ndarray:
    """(S, S) bool: superpixels that touch within a 3x3 reach, and each
    one itself."""
    adj = np.zeros((S + 1, S + 1), bool)
    m = np.minimum(spx, S)
    H, W = m.shape
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            a = m[max(0, dy):H + min(0, dy), max(0, dx):W + min(0, dx)]
            b = m[max(0, -dy):H + min(0, -dy), max(0, -dx):W + min(0, -dx)]
            adj[a.reshape(-1), b.reshape(-1)] = True
    adj = adj[:S, :S]
    np.fill_diagonal(adj, True)
    return adj


def pseudo_labels(feat, probs, spx, selected, targets, max_protos: int,
                  chunk: int = 1 << 18) -> torch.Tensor:
    """feat (Ch, H, W) L2-normalised float32, probs (C, H, W), spx (H, W)
    int numpy, selected: the selected superpixel ids, targets (S, C)
    multi-hot numpy. Returns (H, W) int64 labels, 255 unassigned."""
    dev = feat.device
    Ch, H, W = feat.shape
    C = probs.shape[0]
    S = targets.shape[0]
    P = H * W
    sel = np.zeros(S, bool)
    sel[np.asarray(selected, np.int64)] = True
    sid_np, cls_np = np.nonzero((targets > 0) & sel[:, None])
    sid_np, cls_np = sid_np[:max_protos], cls_np[:max_protos]
    f = feat.reshape(Ch, P).t()
    pr = probs.reshape(C, P).t()
    sp = torch.as_tensor(spx.reshape(-1).astype(np.int64), device=dev)
    valid = torch.as_tensor(sel[np.minimum(spx.reshape(-1), S - 1)]
                            & (spx.reshape(-1) < S), device=dev)
    # 1. prototypes
    sid = torch.as_tensor(sid_np, device=dev)
    cls = torch.as_tensor(cls_np, device=dev)
    pix = torch.arange(P, device=dev)
    src = torch.empty(len(sid_np), dtype=torch.long, device=dev)
    for k in range(len(sid_np)):
        inside = valid & (sp == sid[k])
        v = torch.where(inside, pr[:, cls[k]], -1.0)
        best = v.max()
        src[k] = pix[inside & (v == best)].min()
    proto = f[src]  # (NP, Ch)
    # 2. nearest prototype of the pixel's own superpixel
    NP = len(sid_np)
    nn_sim = torch.full((P,), NEG, device=dev)
    nn_k = torch.zeros(P, dtype=torch.long, device=dev)
    for lo in range(0, P, chunk):
        hi = min(lo + chunk, P)
        s = f[lo:hi] @ proto.t()
        own = sid[None, :] == sp[lo:hi, None]
        s = torch.where(own, s, NEG)
        nn_sim[lo:hi], nn_k[lo:hi] = s.max(dim=1)
    assigned = valid & (nn_sim > NEG / 2)
    # 3. lower-median thresholds
    thr = torch.ones(NP, device=dev)
    for k in range(NP):
        vals = torch.sort(nn_sim[assigned & (nn_k == k)]).values
        if len(vals):
            thr[k] = vals[(len(vals) - 1) // 2]
    # 4. propagation from adjacent selected superpixels
    adj = torch.as_tensor(adjacency(spx, S), device=dev)
    out = torch.full((P,), 255, dtype=torch.long, device=dev)
    for lo in range(0, P, chunk):
        hi = min(lo + chunk, P)
        s = f[lo:hi] @ proto.t()
        cand = adj[sp[lo:hi].clamp(max=S - 1)][:, sid] \
            & (sp[lo:hi, None] < S)
        passing = cand & (s > thr[None, :])
        best_sid = torch.where(passing, sid[None, :], -1).max(dim=1).values
        pick = cand & (sid[None, :] == best_sid[:, None])
        j = torch.where(pick, s, NEG).max(dim=1).indices
        out[lo:hi] = torch.where(best_sid >= 0, cls[j], 255)
    # 5. the pixel's own superpixel wins
    out = torch.where(assigned, cls[nn_k], out)
    return out.reshape(H, W)
