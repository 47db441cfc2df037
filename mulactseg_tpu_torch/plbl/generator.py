"""Pseudo-label generation loop (the eval_AL --method eval_save_* steps):
the port of mulactseg_tpu/plbl/generator.py for the cosine-prototype types.

Walks the labelled set at full resolution, one image at a time: the uint8
image goes to the device and is normalised there, the eval forward returns
features and logits, the float32 softmax and cosine_prototype_plbl run on
the device, and the uint8 map comes back to the host, where it updates the
C+1-class confusion matrix against the precise GT and is saved as
<save_dir>/<label id>.png (path convention of
trainer/eval_save_cosplbl_prop.py:35-44, scores :88-117). The host work of
the next image (prototype table, adjacency) runs on one worker thread
meanwhile. With use_tta (the VOC recipe's
eval_save_cosplbl_prop_includeonehot_voc_ms), the forward is the 10-view
test-time augmentation of engine/tta.py, whose averaged features stay
float32.

Type -> reference generator:
  cosprop                      eval_save_cosplbl_prop.py
  cosprop_includeonehot        eval_save_cosplbl_prop_includeonehot.py
  cosprop_filtered             eval_save_cosplbl_prop_filtered.py
  cos_withinspx                eval_save_cosplbl_prop_withinspx.py
  cos_withinspx_includeonehot / cosplbl   eval_save_cosplbl.py,
                                          eval_save_plbl.py
  cosplbl_filtgt               eval_save_cosplbl_filtgt.py
The other types of PLBL_TYPES and save_vis are not ported yet (ROADMAP.md
queue A, item 15).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from mulactseg_tpu_torch.device import resolve_device
from mulactseg_tpu_torch.engine.evaluate import eval_forward
from mulactseg_tpu_torch.engine.tta import tta_feat_forward
from mulactseg_tpu_torch.plbl.cosine_prop import (
    cosine_prototype_plbl,
    selected_spx_adjacency,
)
from mulactseg_tpu_torch.utils.metrics import MeanIoU
from mulactseg_tpu_torch.utils.png import write_gray8

# name: (include_onehot, propagate, filter_within, filter_prop)
_COS_TYPES = {
    "cosprop": (False, True, False, False),
    "cosprop_includeonehot": (True, True, False, False),
    "cosprop_filtered": (False, True, False, True),
    "cos_withinspx": (False, False, False, False),
    "cos_withinspx_includeonehot": (True, False, False, False),
    "cosplbl": (True, False, False, False),
    "cosplbl_filtgt": (True, False, True, False),
}

PLBL_TYPES = tuple(sorted(
    set(_COS_TYPES) | {"cosprop_includeonehot_slide", "cosprop_plusonehot",
                       "cos_naiveprop", "cosprop_onehot",
                       "cosprop_onehotignore"})) + (
    "naive_argmax", "naive", "within_multihot", "candidate",
    "candidate_prop")

# reference trainer-module names -> plbl types
METHOD_TO_PLBL = {
    "eval_save_cosplbl_prop": "cosprop",
    "eval_save_cosplbl_prop_includeonehot": "cosprop_includeonehot",
    "eval_save_cosplbl_prop_includeonehot_slide": "cosprop_includeonehot_slide",
    "eval_save_cosplbl_prop_includeonehot_voc": "cosprop_includeonehot",
    "eval_save_cosplbl_prop_includeonehot_voc_ms": "cosprop_includeonehot",
    "eval_save_cosplbl_naive_voc": "naive_argmax",
    "eval_save_cosplbl_naive_voc_ms": "naive_argmax",
    "eval_save_naiveplbl": "naive",
    "eval_save_plbl": "cosplbl",
    "eval_save_cosplbl": "cosplbl",
    "eval_save_cosplbl_filtgt": "cosplbl_filtgt",
    "eval_save_cosplbl_naiveprop": "cos_naiveprop",
    "eval_save_cosplbl_prop_filtered": "cosprop_filtered",
    "eval_save_cosplbl_prop_onehot": "cosprop_onehot",
    "eval_save_cosplbl_prop_onehotignore": "cosprop_onehotignore",
    "eval_save_cosplbl_prop_plusonehot": "cosprop_plusonehot",
    "eval_save_cosplbl_prop_withinspx": "cos_withinspx",
    "eval_save_candidateplbl": "candidate",
    "eval_save_candidateplbl_prop": "candidate_prop",
}

_NOT_PORTED = ("is not ported yet: ROADMAP.md queue A, item 15 (remaining "
               "evals)")


class PseudoLabelGenerator:
    def __init__(self, model: torch.nn.Module, cfg,
                 plbl_type: str = "cosprop_includeonehot",
                 use_tta: bool = False, max_protos: int = 1024,
                 device="cuda"):
        if plbl_type not in PLBL_TYPES:
            raise KeyError(f"unknown plbl type {plbl_type!r}; have "
                           f"{PLBL_TYPES}")
        if plbl_type not in _COS_TYPES:
            raise NotImplementedError(f"plbl type {plbl_type!r} "
                                      + _NOT_PORTED)
        self.model = model
        self.cfg = cfg
        self.plbl_type = plbl_type
        self.use_tta = use_tta
        self.max_protos = max_protos
        self.dev = resolve_device(device)
        self.autocast = self.dev.type == "cuda" and cfg.dtype == "bfloat16"
        # bf16 similarities when the network computes in bf16, and a bf16
        # feature hand-off too, but for TTA, whose views average float32
        # features (JAX generator.py:184-191, 237, 652-655)
        self.sim_bf16 = cfg.dtype == "bfloat16"
        self.feat_bf16 = self.sim_bf16 and not use_tta

    def generate(self, model_state, loader: Iterable, *,
                 save_dir: Optional[str] = None,
                 suppix: Optional[dict] = None):
        """model_state: a state_dict to load first, or None to use the
        model's weights as they are. loader yields single-image batches
        with 'images' (1, 3, H, W) uint8 or normalised float32, 'labels'
        (1, H, W), 'target' (1, S, C+1) multi-hot, 'spx' (1, H, W),
        'spmask' (1, H, W) and 'fnames' [[image, label, spx]] (the
        eval_region_*_all contract). `suppix` maps spx path -> selected
        superpixel ids. Returns (miou, iou_table, precision_table,
        recall_table)."""
        cfg = self.cfg
        if save_dir and cfg.save_vis:
            raise NotImplementedError("save_vis (boundary overlays, "
                                      "ops/morphology.py) " + _NOT_PORTED)
        if model_state is not None:
            self.model.load_state_dict(model_state)
        iou = MeanIoU(cfg.num_classes + 1, cfg.ignore_idx)
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
        with ThreadPoolExecutor(max_workers=1) as pool:
            it = iter(loader)
            batch = next(it, None)
            prep = (pool.submit(self.host_prep, batch, suppix)
                    if batch is not None else None)
            while batch is not None:
                nxt = next(it, None)
                this_prep = prep.result()
                prep = (pool.submit(self.host_prep, nxt, suppix)
                        if nxt is not None else None)
                plbl = self.plbl_for_batch(batch, prep=this_prep)
                with record_function("plbl.fetch"):
                    u8 = plbl.to(torch.uint8).cpu().numpy()
                with record_function("plbl.save"):
                    iou._after_step_host(u8, batch["labels"])
                    if save_dir:
                        lbl_id = os.path.basename(
                            batch["fnames"][0][1]).split(".")[0]
                        write_gray8(os.path.join(save_dir, f"{lbl_id}.png"),
                                    u8)
                batch = nxt
        ious, precs, recs = iou._after_epoch_ipr()
        miou = float(np.mean(ious))

        def fmt(xs):
            return ",".join([f"{np.mean(xs):.2f}"] + [f"{v:.2f}" for v in xs])

        return miou, fmt(ious), fmt(precs), fmt(recs)

    def host_prep(self, batch, suppix: Optional[dict] = None):
        """Host-side (numpy) work for one image: the selected-superpixel
        prototype table and adjacency, and pixel validity. Returns
        (targets, spmask, proto_sid, proto_cls, proto_valid, proto_adj,
        pixel_valid)."""
        cfg = self.cfg
        include_onehot = _COS_TYPES[self.plbl_type][0]
        spx_map = np.asarray(batch["spx"][0])
        spmask = np.asarray(batch["spmask"][0]).astype(bool)
        targets = np.asarray(batch["target"][0], np.float32)
        selected = (suppix or {}).get(batch["fnames"][0][2], [])
        proto_sid, proto_cls, proto_valid, proto_adj = \
            selected_spx_adjacency(spx_map, selected, cfg.nseg, targets,
                                   self.max_protos, include_onehot)
        pixel_valid = spmask.reshape(-1).copy()
        if not include_onehot:
            multi = targets.sum(1) > 1
            pixel_valid &= multi[np.clip(spx_map.reshape(-1), 0,
                                         cfg.nseg - 1)]
        return (targets, spmask, proto_sid, proto_cls, proto_valid,
                proto_adj, pixel_valid)

    def plbl_for_batch(self, batch, suppix: Optional[dict] = None,
                       prep=None) -> torch.Tensor:
        """One image's (H, W) int32 pseudo-label map, on the device.
        `prep` is an optional precomputed host_prep result."""
        cfg = self.cfg
        _, propagate, filt_within, filt_prop = _COS_TYPES[self.plbl_type]
        if prep is None:
            prep = self.host_prep(batch, suppix)
        _, _, proto_sid, proto_cls, proto_valid, proto_adj, pixel_valid = prep
        spx_map = np.asarray(batch["spx"][0])
        H, W = spx_map.shape
        P = H * W
        with record_function("plbl.forward"):
            if self.use_tta:
                feat, logits = tta_feat_forward(self.model, batch["images"],
                                                self.dev, self.autocast)
            else:
                feat, logits = eval_forward(self.model, batch["images"],
                                            self.dev, self.autocast,
                                            return_feat=True,
                                            feat_bf16=self.feat_bf16)
        with record_function("plbl.softmax"):
            probs = torch.softmax(logits[0].float(), dim=0)  # (C, H, W)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

        # (Ch, P) and (C, P) planes viewed as (P, Ch) and (P, C): no copy
        plbl = cosine_prototype_plbl(
            feat[0].reshape(feat.shape[1], P).t(),
            probs.reshape(probs.shape[0], P).t(),
            dev(spx_map.reshape(-1)), dev(pixel_valid), dev(proto_sid),
            dev(proto_cls), dev(proto_valid), dev(proto_adj), nseg=cfg.nseg,
            threshold_median=cfg.cosprop_threshold_method == "median",
            propagate=propagate, filter_within_by_pred=filt_within,
            filter_prop_by_pred=filt_prop, sim_bf16=self.sim_bf16)
        return plbl.view(H, W)


def plbl_save_dir(checkpoint_path: str, plbl_type: Optional[str],
                  round_id: str) -> str:
    """The reference's directory convention
    (eval_save_cosplbl_prop.py:35-44)."""
    d = os.path.dirname(checkpoint_path)
    if plbl_type:
        return os.path.join(d, f"plbl_gen_{plbl_type}", f"round_{round_id}")
    return os.path.join(d, "plbl_gen", f"round_{round_id}")
