"""Analysis evals (the reference's eval_* trainers that score intermediate
artifacts instead of saving pseudo labels) and the top-1 selection probe:
the port of mulactseg_tpu/engine/analysis.py.

Method -> what it scores (reference file in trainer/):
  eval_cosplbl_within_multihot        within-superpixel nearest-prototype
                                      plbl, IoU + precision/recall
  eval_ensemble_plbl_within_multihot  the same plbl, IoU only
  eval_maxcosplbl_within_multihot     the same plbl
  eval_cosplbl_filt_within_multihot   that plbl kept where the model's
                                      argmax agrees (cosplbl_filtgt)
  eval_within_multihot(_voc)          top-1 within the candidate set
  eval_all_cosplbl_prop               the propagated plbl, scored within
                                      the predicted region, + precision/
                                      recall
  eval_all_dominant                   the per-pixel dominant map in
                                      'target' as the prediction, no
                                      forward
  eval_naive_vis                      plain C-class eval (+ the undefined
                                      class's IoU) and colour overlays
  eval_vistopone_within_multihot      within-superpixel plbl + overlays
  eval_selected_spx_plbl              the same, minus round-1 selections

active_joint_multi_analysis (SelectionAccuracyEvaluator) asks, for every
labelled superpixel and candidate class, whether the precise GT at the
pixel of highest softmax probability of that class is that class. The
(superpixel, class) max and its first pixel are K5
(ops/segment_max.seg_max_fwd), once an image.

Every entry point runs on the card unless asked for the CPU. Under data
parallelism (parallel/mesh.py) each rank scores the whole images of its
batches (DataProvider(split="batches"), as engine/evaluate.Evaluator
takes them), writes their overlays, and the confusion matrices and the
probe's counts are summed over the ranks: every rank reports exactly
what one rank counts.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from mulactseg_tpu_torch.device import resolve_device
from mulactseg_tpu_torch.engine.evaluate import (
    eval_forward,
    require_batch_split,
)
from mulactseg_tpu_torch.ops.segment_max import seg_max_fwd
from mulactseg_tpu_torch.parallel import mesh
from mulactseg_tpu_torch.plbl.generator import (
    PseudoLabelGenerator,
    save_overlay,
)
from mulactseg_tpu_torch.utils.metrics import IoUIgnore, MeanIoU

# method -> (plbl type for PseudoLabelGenerator, options)
ANALYSIS_METHODS: Dict[str, Dict] = {
    "eval_cosplbl_within_multihot": {
        "plbl": "cos_withinspx_includeonehot", "ipr": True},
    "eval_ensemble_plbl_within_multihot": {
        "plbl": "cos_withinspx_includeonehot"},
    "eval_maxcosplbl_within_multihot": {
        "plbl": "cos_withinspx_includeonehot"},
    "eval_cosplbl_filt_within_multihot": {"plbl": "cosplbl_filtgt"},
    "eval_within_multihot": {"plbl": "within_multihot"},
    "eval_within_multihot_voc": {"plbl": "within_multihot"},
    "eval_all_cosplbl_prop": {
        "plbl": "cosprop", "ipr": True, "within_predregion": True},
    "eval_all_dominant": {"pred": "target", "ipr": True},
    "eval_naive_vis": {"pred": "argmax", "save_vis": True},
    "eval_vistopone_within_multihot": {
        "plbl": "cos_withinspx_includeonehot", "save_vis": True},
    "eval_selected_spx_plbl": {
        "plbl": "cos_withinspx_includeonehot", "save_vis": True,
        "exclude_round": 1},
}


def _fmt(xs):
    return ",".join([f"{np.mean(xs):.2f}"] + [f"{v:.2f}" for v in xs])


def _exclude_previous_round(suppix: dict, prev_suppix: dict) -> dict:
    """eval_selected_spx_plbl.py:46-57: the superpixels not selected in the
    earlier round; images left with none drop out."""
    out = {}
    for spx_path, ids in suppix.items():
        prev = set(prev_suppix.get(spx_path, []))
        kept = [i for i in ids if i not in prev]
        if kept:
            out[spx_path] = kept
    return out


class AnalysisEvaluator:
    """One analysis method over an eval_region_*_all loader (single-image
    batches). run() returns 'miou' and 'iou_table', with
    'precision_table' and 'recall_table' where the method reports them
    and 'ignore_iou' for eval_naive_vis on a model with the undefined
    head, and keeps the summed confusion matrix in self.confusion."""

    def __init__(self, model: torch.nn.Module, cfg, method: str,
                 device="cuda"):
        if method not in ANALYSIS_METHODS:
            raise KeyError(f"unknown analysis method {method!r}; "
                           f"have {sorted(ANALYSIS_METHODS)}")
        self.model = model
        self.cfg = cfg
        self.method = method
        self.opts = ANALYSIS_METHODS[method]
        self.dev = resolve_device(device)
        self.autocast = self.dev.type == "cuda" and cfg.dtype == "bfloat16"
        self.gen = (PseudoLabelGenerator(model, cfg, self.opts["plbl"],
                                         device=self.dev)
                    if "plbl" in self.opts else None)
        self.confusion = None

    def run(self, model_state, loader: Iterable, *,
            suppix: Optional[dict] = None, prev_suppix: Optional[dict] = None,
            save_dir: Optional[str] = None, logger=None) -> Dict:
        """model_state: a state_dict to load first, or None. On several
        ranks loader is a DataProvider(split="batches"); each overlay is
        written by the rank that scores its image."""
        require_batch_split(loader, "AnalysisEvaluator.run")
        cfg, opts = self.cfg, self.opts
        if model_state is not None:
            self.model.load_state_dict(model_state)
        if opts.get("exclude_round") and prev_suppix:
            suppix = _exclude_previous_round(suppix or {}, prev_suppix)
        argmax_mode = opts.get("pred") == "argmax"
        # eval_naive_vis scores the C real classes and the undefined class
        # apart (eval_naive_vis.py:47-48); the plbl analyses score C+1
        iou = MeanIoU(cfg.num_classes if argmax_mode else cfg.num_classes + 1,
                      cfg.ignore_idx)
        # only a model with the undefined head (VOC's has none) has a
        # channel to slice off and score apart
        has_undef_head = cfg.num_model_classes == cfg.num_classes + 1
        ignore_iou = (IoUIgnore(cfg.num_classes, cfg.ignore_idx)
                      if argmax_mode and has_undef_head else None)
        vis = bool(save_dir) and (opts.get("save_vis") or cfg.save_vis)
        if vis:
            os.makedirs(save_dir, exist_ok=True)

        for batch in loader:
            labels = torch.as_tensor(np.asarray(batch["labels"]))
            spx_map = None
            if opts.get("pred") == "target":
                # the annotation itself is the prediction
                pred = torch.as_tensor(np.asarray(
                    batch["target"][0]).astype(np.int32))[None]
                spx_map = batch["spx"][0]
            elif argmax_mode:
                logits = eval_forward(self.model, batch["images"], self.dev,
                                      self.autocast)
                labels = labels.to(self.dev)
                # conventional IoU over the C real classes
                # (eval_naive_vis.py:70)
                cls_logits = logits[:, :-1] if has_undef_head else logits
                pred = cls_logits.argmax(1)
                if ignore_iou is not None:
                    ignore_iou._after_step({"outputs": logits.argmax(1),
                                            "targets": labels})
            else:
                pred = self.gen.plbl_for_batch(batch, suppix)[None]
                labels = labels.to(self.dev)
                spx_map = batch["spx"][0]

            step = {"outputs": pred, "targets": labels}
            if opts.get("within_predregion"):
                iou._after_step_within_predregion(step)
            else:
                iou._after_step(step)

            if vis:
                lbl_id = os.path.basename(
                    batch["fnames"][0][1]).split(".")[0]
                save_overlay(cfg, pred[0].cpu().numpy(), spx_map,
                             os.path.join(save_dir, f"{lbl_id}.png"),
                             self.dev)

        iou.all_reduce(self.dev)
        if ignore_iou is not None:
            ignore_iou.all_reduce(self.dev)
        self.confusion = iou.confusion()
        out: Dict = {}
        if opts.get("ipr"):
            ious, precs, recs = iou._after_epoch_ipr()
            out["precision_table"] = _fmt(precs)
            out["recall_table"] = _fmt(recs)
        else:
            ious = iou._after_epoch()
        out["miou"] = float(np.mean(ious))
        out["iou_table"] = _fmt(ious)
        if ignore_iou is not None:
            # the undefined class's IoU, appended (eval_naive_vis.py:95-98)
            out["ignore_iou"] = ignore_iou._after_epoch()
            out["iou_table"] += f",{out['ignore_iou']:.2f}"
        if logger is not None:
            logger.info("[%s] IoU: %s", self.method, out["iou_table"])
            for k in ("precision_table", "recall_table"):
                if k in out:
                    logger.info("[%s] %s: %s", self.method, k, out[k])
        return out


def top1_selection_counts(logits, multihot, spx, spmask, gt, *, nseg: int,
                          num_classes: int):
    """The probe's counts over a batch (trainer/active_joint_multi_
    analysis.py:27-102). logits (B, C, H, W); multihot (B, S, C'); spx,
    spmask, gt (B, H, W); every tensor on one device.

    Per image, K5 gives for each (superpixel, class) the first pixel of
    highest softmax probability among the spmask pixels (masked pixels
    take id nseg; an absent superpixel gives pixel P, and counts for
    nothing). A (superpixel, class) pair counts where the class is a
    candidate of the multi-hot row; it is correct where the GT there is
    the class. GT 255 counts as incorrect in the totals and leaves the
    per-class bins. Returns float64 (ncorr_cls (num_classes,), n_cls
    (num_classes,), ncorr_total, n_total) as tensors."""
    B, C, H, W = logits.shape
    P = H * W
    dev = logits.device
    ncorr_cls = torch.zeros(num_classes, dtype=torch.float64, device=dev)
    n_cls = torch.zeros(num_classes, dtype=torch.float64, device=dev)
    ncorr = torch.zeros((), dtype=torch.float64, device=dev)
    n = torch.zeros((), dtype=torch.float64, device=dev)
    classes = torch.arange(C, device=dev)
    for b in range(B):
        # (C, P) planes viewed as (P, C)
        probs = torch.softmax(logits[b].float(), dim=0).reshape(C, P).t()
        sid = torch.where(spmask[b].reshape(P).bool(),
                          spx[b].reshape(P).int(), nseg).int()
        _, amax = seg_max_fwd(probs, sid, nseg)  # (S, C), P where absent
        amax = amax.long()
        valid_seg = amax[:, 0] < P
        gt_at = gt[b].reshape(P).long()[amax.clamp(max=P - 1)]  # (S, C)
        want = multihot[b][:, :num_classes].bool() & valid_seg[:, None]
        correct = want & (gt_at == classes[None, :])
        bins = gt_at.clamp(0, num_classes)  # 255 -> bin num_classes
        n_cls += torch.bincount(bins[want], minlength=num_classes + 1)[
            :num_classes].double()
        ncorr_cls += torch.bincount(bins[correct],
                                    minlength=num_classes + 1)[
            :num_classes].double()
        ncorr += correct.sum()
        n += want.sum()
    return ncorr_cls, n_cls, ncorr, n


class SelectionAccuracyEvaluator:
    """active_joint_multi_analysis: top-1 selection accuracy over the
    labelled set (trainer/active_joint_multi_analysis.py:27-102; its
    train_impl raises upstream, so this evaluates only)."""

    def __init__(self, model: torch.nn.Module, cfg, device="cuda"):
        self.model = model
        self.cfg = cfg
        self.dev = resolve_device(device)
        self.autocast = self.dev.type == "cuda" and cfg.dtype == "bfloat16"

    def run(self, model_state, loader: Iterable, *, selection_iter: int = 0,
            logger=None) -> Dict:
        """model_state: a state_dict to load first, or None. loader yields
        'images', 'target' (B, S, C+1), 'spx', 'spmask' and 'labels' (the
        precise GT); on several ranks it is a DataProvider(split=
        "batches"), and the counts are summed over the ranks. Returns
        acc_total, acc_cls and the counts ncorr_cls, n_cls, ncorr_total
        and n_total."""
        require_batch_split(loader, "SelectionAccuracyEvaluator.run")
        cfg = self.cfg
        if model_state is not None:
            self.model.load_state_dict(model_state)
        ncorr_cls = np.zeros(cfg.num_classes)
        n_cls = np.zeros(cfg.num_classes)
        ncorr_total = n_total = 0.0

        def dev(key):
            return torch.as_tensor(np.asarray(batch[key])).to(self.dev)

        for batch in loader:
            logits = eval_forward(self.model, batch["images"], self.dev,
                                  self.autocast)
            cc, nc, ct, nt = top1_selection_counts(
                logits, dev("target"), dev("spx"), dev("spmask"),
                dev("labels"), nseg=cfg.nseg, num_classes=cfg.num_classes)
            ncorr_cls += cc.cpu().numpy()
            n_cls += nc.cpu().numpy()
            ncorr_total += float(ct)
            n_total += float(nt)
        if mesh.active():  # float64 sums of integer counts: exact
            counts = mesh.all_reduce_sum(torch.from_numpy(np.concatenate(
                [ncorr_cls, n_cls, [ncorr_total, n_total]])).to(self.dev))
            counts = counts.cpu().numpy()
            C = cfg.num_classes
            ncorr_cls, n_cls = counts[:C], counts[C:2 * C]
            ncorr_total, n_total = float(counts[-2]), float(counts[-1])
        acc_total = ncorr_total / max(n_total, 1.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            acc_cls = ncorr_cls / n_cls
        msg = "[AL {}-round]: evaluation\n{},{}".format(
            selection_iter, acc_total,
            ",".join(str(a) for a in acc_cls.tolist()))
        if logger is not None:
            logger.info(msg)
        elif mesh.is_main():
            print(msg, flush=True)
        return {"acc_total": acc_total, "acc_cls": acc_cls,
                "ncorr_cls": ncorr_cls, "n_cls": n_cls,
                "ncorr_total": ncorr_total, "n_total": n_total}
