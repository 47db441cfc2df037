"""Pseudo-label generation loop (the eval_AL --method eval_save_* steps):
the port of mulactseg_tpu/plbl/generator.py, every type of PLBL_TYPES.

Walks the labelled set at full resolution, one image at a time: the uint8
image goes to the device and is normalised there, the eval forward returns
features and logits, the float32 softmax and cosine_prototype_plbl (or a
simple generator of plbl/simple.py) run on the device, and the uint8 map
comes back to the host, where it updates the C+1-class confusion matrix
against the precise GT and is saved as <save_dir>/<label id>.png (path
convention of trainer/eval_save_cosplbl_prop.py:35-44, scores :88-117).
The host work of the next image (prototype table, adjacency) runs on one
worker thread meanwhile. With use_tta (the VOC recipe's
eval_save_cosplbl_prop_includeonehot_voc_ms), the forward is the 10-view
test-time augmentation of engine/tta.py; the _slide type's is the
feature-summing sliding window of engine/sliding.py; both keep float32
features. With cfg.save_vis, a colour overlay with the superpixel
boundaries in yellow goes to <save_dir>_vis/<label id>.png
(eval_save_cosplbl_prop.py:70-86).

Type -> reference generator:
  cosprop                      eval_save_cosplbl_prop.py
  cosprop_includeonehot        eval_save_cosplbl_prop_includeonehot.py
  cosprop_includeonehot_slide  ..._includeonehot_slide.py (sliding feats)
  cosprop_filtered             eval_save_cosplbl_prop_filtered.py
  cosprop_plusonehot           eval_save_cosplbl_prop_plusonehot.py
  cosprop_onehot(ignore)       eval_save_cosplbl_prop_onehot(ignore).py
  cos_withinspx                eval_save_cosplbl_prop_withinspx.py
  cos_withinspx_includeonehot / cosplbl   eval_save_cosplbl.py,
                                          eval_save_plbl.py
  cosplbl_filtgt               eval_save_cosplbl_filtgt.py
  cos_naiveprop                eval_save_cosplbl_naiveprop.py
  within_multihot / candidate  eval_save_candidateplbl.py
  candidate_prop               eval_save_candidateplbl_prop.py
  naive_argmax                 eval_save_cosplbl_naive_voc.py
  naive                        eval_save_naiveplbl.py
The cosprop_onehot types read `target` as the per-pixel dominant-label map
(255 = unselected), which no loader of the JAX package hands the
generator (ROADMAP.md, open question 7).
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
from mulactseg_tpu_torch.parallel import mesh
from mulactseg_tpu_torch.plbl.cosine_prop import (
    cosine_prototype_plbl,
    selected_spx_adjacency,
)
from mulactseg_tpu_torch.plbl.simple import (
    naive_argmax_plbl,
    naive_threshold_fill,
    naive_threshold_plbl,
    within_multihot_plbl,
)
from mulactseg_tpu_torch.utils.metrics import MeanIoU
from mulactseg_tpu_torch.utils.png import write_gray8, write_rgb8

# name: (include_onehot, propagate, filter_within, filter_prop)
_COS_TYPES = {
    "cosprop": (False, True, False, False),
    "cosprop_includeonehot": (True, True, False, False),
    "cosprop_includeonehot_slide": (True, True, False, False),
    "cosprop_filtered": (False, True, False, True),
    "cosprop_plusonehot": (False, True, False, False),
    "cos_withinspx": (False, False, False, False),
    "cos_withinspx_includeonehot": (True, False, False, False),
    "cosplbl": (True, False, False, False),
    "cosplbl_filtgt": (True, False, True, False),
    "cos_naiveprop": (True, False, False, False),
    "cosprop_onehot": (True, True, False, False),
    "cosprop_onehotignore": (True, True, False, False),
}

PLBL_TYPES = tuple(sorted(_COS_TYPES)) + (
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


def decode_labels(cfg, labels: np.ndarray) -> np.ndarray:
    """Colour-decode an (H, W) label map for a visualisation: 255 -> the
    extra class C first (torch.masked_fill(plbl, plbl == 255, C)), then
    the Cityscapes colours or the VOC palette."""
    from mulactseg_tpu_torch.data.constants import (
        decode_cityscapes,
        voc_cmap,
    )

    filled = np.where(labels == 255, cfg.num_classes, labels)
    if cfg.dataset == "voc":
        return voc_cmap()[np.clip(filled, 0, 255)].astype(np.uint8)
    return decode_cityscapes(filled)


def save_overlay(cfg, labels: np.ndarray, spx_map, path: str,
                 dev) -> None:
    """Writes the colour-decoded labels as an RGB PNG, with the superpixel
    boundaries of spx_map (ops/morphology.boundary_mask, on `dev`) in
    yellow where spx_map is given: the skimage mark_boundaries
    equivalent."""
    from mulactseg_tpu_torch.ops.morphology import boundary_mask

    color = decode_labels(cfg, labels)
    if spx_map is not None:
        b = boundary_mask(torch.as_tensor(np.asarray(spx_map)).to(
            dev)).cpu().numpy()
        color[b] = (255, 255, 0)
    write_rgb8(path, color)


class PseudoLabelGenerator:
    def __init__(self, model: torch.nn.Module, cfg,
                 plbl_type: str = "cosprop_includeonehot",
                 use_tta: bool = False, max_protos: int = 1024,
                 device="cuda"):
        if plbl_type not in PLBL_TYPES:
            raise KeyError(f"unknown plbl type {plbl_type!r}; have "
                           f"{PLBL_TYPES}")
        self.model = model
        self.cfg = cfg
        self.plbl_type = plbl_type
        self.use_tta = use_tta
        self.max_protos = max_protos
        self.dev = resolve_device(device)
        self.autocast = self.dev.type == "cuda" and cfg.dtype == "bfloat16"
        self.sliding = None
        if plbl_type.endswith("_slide"):
            from mulactseg_tpu_torch.engine.sliding import SlidingEval

            # the feature-summing twin (utils/sliding_evaluator_plbl.py:
            # 16-29); it keeps every logit channel
            self.sliding = SlidingEval(
                model, cfg.num_classes + 1, crop_size=cfg.slide_crop,
                stride_rate=cfg.slide_stride_rate, return_feat=True,
                device=self.dev, autocast=self.autocast)
        # bf16 similarities when the network computes in bf16, and a bf16
        # feature hand-off too, but for TTA and sliding, whose views sum
        # float32 features (JAX generator.py:184-191, 237, 652-655)
        self.sim_bf16 = cfg.dtype == "bfloat16"
        self.feat_bf16 = (self.sim_bf16 and not use_tta
                          and self.sliding is None)

    def generate(self, model_state, loader: Iterable, *,
                 save_dir: Optional[str] = None,
                 suppix: Optional[dict] = None):
        """model_state: a state_dict to load first, or None to use the
        model's weights as they are. loader yields single-image batches
        with 'images' (1, 3, H, W) uint8 or normalised float32, 'labels'
        (1, H, W), 'target' (1, S, C+1) multi-hot (the per-pixel dominant
        map (1, H, W) for the cosprop_onehot types), 'spx' (1, H, W),
        'spmask' (1, H, W) and 'fnames' [[image, label, spx]] (the
        eval_region_*_all contract). `suppix` maps spx path -> selected
        superpixel ids. Returns (miou, iou_table, precision_table,
        recall_table).

        The JAX package pseudo-labels on one device: under data
        parallelism rank 0 generates (the others never read their
        loader) and the others wait until it has written every PNG, then
        return its results."""
        if mesh.world() > 1:
            out = (self._generate(model_state, loader, save_dir, suppix)
                   if mesh.is_main() else None)
            return mesh.broadcast_object(out)
        return self._generate(model_state, loader, save_dir, suppix)

    def _generate(self, model_state, loader, save_dir, suppix):
        cfg = self.cfg
        if model_state is not None:
            self.model.load_state_dict(model_state)
        iou = MeanIoU(cfg.num_classes + 1, cfg.ignore_idx)
        vis_dir = f"{save_dir}_vis" if save_dir and cfg.save_vis else None
        for d in (save_dir, vis_dir):
            if d:
                os.makedirs(d, exist_ok=True)
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
                        if vis_dir:
                            save_overlay(cfg, u8, batch["spx"][0],
                                         os.path.join(vis_dir,
                                                      f"{lbl_id}.png"),
                                         self.dev)
                batch = nxt
        ious, precs, recs = iou._after_epoch_ipr()
        miou = float(np.mean(ious))

        def fmt(xs):
            return ",".join([f"{np.mean(xs):.2f}"] + [f"{v:.2f}" for v in xs])

        return miou, fmt(ious), fmt(precs), fmt(recs)

    def _dominant_to_targets(self, dom: np.ndarray, spx_map: np.ndarray):
        """The label-expansion ablation's targets
        (eval_save_cosplbl_prop_onehot.py:92-104): a one-hot row per
        superpixel from a per-pixel dominant-label map (255 = unselected),
        the highest class of its pixels, 255 inside a selected superpixel
        -> the extra class C. cosprop_onehot drops that channel. Returns
        (targets (S, Ct), spmask, selected ids)."""
        cfg = self.cfg
        S, C = cfg.nseg, cfg.num_classes
        spmask = dom != 255
        flat_idx = spx_map.reshape(-1)
        flat_dom = dom.reshape(-1)
        seg_cls = np.full(S, -1, np.int64)
        sel = flat_dom != 255
        np.maximum.at(seg_cls, flat_idx[sel], flat_dom[sel].astype(np.int64))
        seg_cls_filled = np.where(seg_cls == 255, C, seg_cls)
        onehot = np.zeros((S, C + 1), np.float32)
        has = seg_cls >= 0
        onehot[np.arange(S)[has], np.clip(seg_cls_filled[has], 0, C)] = 1.0
        if self.plbl_type == "cosprop_onehot":
            onehot = onehot[:, :-1]
        return onehot, spmask, np.nonzero(has)[0].tolist()

    def host_prep(self, batch, suppix: Optional[dict] = None):
        """Host-side (numpy) work for one image of a cosine type: the
        targets (from the dominant map for the onehot types), the
        selected-superpixel prototype table and adjacency, and pixel
        validity. Returns (targets, spmask, proto_sid, proto_cls,
        proto_valid, proto_adj, pixel_valid), or None for the simple
        types."""
        if self.plbl_type not in _COS_TYPES:
            return None
        cfg = self.cfg
        include_onehot = _COS_TYPES[self.plbl_type][0]
        spx_map = np.asarray(batch["spx"][0])
        if self.plbl_type.startswith("cosprop_onehot"):
            targets, spmask, selected = self._dominant_to_targets(
                np.asarray(batch["target"][0]).astype(np.int64), spx_map)
        else:
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

    def _tensor(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def plbl_for_batch(self, batch, suppix: Optional[dict] = None,
                       prep=None) -> torch.Tensor:
        """One image's (H, W) int32 pseudo-label map, on the device.
        `prep` is an optional precomputed host_prep result."""
        cfg = self.cfg
        ptype = self.plbl_type
        spx_map = np.asarray(batch["spx"][0])
        H, W = spx_map.shape
        P = H * W
        if ptype not in _COS_TYPES:
            with record_function("plbl.forward"):
                logits = eval_forward(self.model, batch["images"], self.dev,
                                      self.autocast)
            spmask = self._tensor(np.asarray(batch["spmask"][0], bool))
            if ptype == "naive_argmax":
                plbl = naive_argmax_plbl(logits[0], spmask,
                                         num_real_classes=logits.shape[1])
            elif ptype == "naive":
                plbl = naive_threshold_plbl(logits[0], spmask,
                                            plbl_th=cfg.plbl_th)
            else:  # within_multihot, candidate, candidate_prop
                plbl = within_multihot_plbl(
                    logits, self._tensor(np.asarray(batch["target"][0],
                                                    np.float32))[None],
                    self._tensor(spx_map)[None], spmask[None])[0]
                if ptype == "candidate_prop":
                    plbl = naive_threshold_fill(
                        plbl, logits[0], spmask, temp=cfg.ce_temp,
                        plbl_th=cfg.plbl_th)
            return plbl

        _, propagate, filt_within, filt_prop = _COS_TYPES[ptype]
        if prep is None:
            prep = self.host_prep(batch, suppix)
        targets, spmask, proto_sid, proto_cls, proto_valid, proto_adj, \
            pixel_valid = prep
        with record_function("plbl.forward"):
            if self.sliding is not None:
                feat, logits = self.sliding(batch["images"])
            elif self.use_tta:
                feat, logits = tta_feat_forward(self.model, batch["images"],
                                                self.dev, self.autocast)
            else:
                feat, logits = eval_forward(self.model, batch["images"],
                                            self.dev, self.autocast,
                                            return_feat=True,
                                            feat_bf16=self.feat_bf16)
        with record_function("plbl.softmax"):
            probs = torch.softmax(logits[0].float(), dim=0)  # (C, H, W)

        # (Ch, P) and (C, P) planes viewed as (P, Ch) and (P, C): no copy
        plbl = cosine_prototype_plbl(
            feat[0].reshape(feat.shape[1], P).t(),
            probs.reshape(probs.shape[0], P).t(),
            self._tensor(spx_map.reshape(-1)), self._tensor(pixel_valid),
            self._tensor(proto_sid), self._tensor(proto_cls),
            self._tensor(proto_valid), self._tensor(proto_adj),
            nseg=cfg.nseg,
            threshold_median=cfg.cosprop_threshold_method == "median",
            propagate=propagate, filter_within_by_pred=filt_within,
            filter_prop_by_pred=filt_prop, sim_bf16=self.sim_bf16).view(H, W)
        if ptype == "cos_naiveprop":
            plbl = naive_threshold_fill(plbl, logits[0],
                                        self._tensor(spmask),
                                        temp=cfg.ce_temp,
                                        plbl_th=cfg.plbl_th)
        elif ptype == "cosprop_plusonehot":
            # one-hot selected superpixels keep their annotated class
            # (eval_save_cosplbl_prop_plusonehot.py:312-328)
            spc = np.clip(spx_map, 0, cfg.nseg - 1)
            oh_pix = spmask & (targets.sum(1) == 1)[spc]
            oh_cls = targets.argmax(1)[spc].astype(np.int32)
            plbl = torch.where(self._tensor(oh_pix), self._tensor(oh_cls),
                               plbl)
        return plbl


def plbl_save_dir(checkpoint_path: str, plbl_type: Optional[str],
                  round_id: str) -> str:
    """The reference's directory convention
    (eval_save_cosplbl_prop.py:35-44)."""
    d = os.path.dirname(checkpoint_path)
    if plbl_type:
        return os.path.join(d, f"plbl_gen_{plbl_type}", f"round_{round_id}")
    return os.path.join(d, "plbl_gen", f"round_{round_id}")
