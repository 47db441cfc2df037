"""Statistics and visualisation loaders: the port of
mulactseg_tpu/data/stats.py, the reference's analysis one-offs as numpy
over one (S, C+1) histogram per image (tools/label_assignment._hist):

  count_all        per-superpixel size and the number of distinct
                   non-ignore GT classes of each selected superpixel
                   (region_cityscapes_count_all.py:25-52)
  visualize_minor  per-superpixel class composition: multi-hot with an
                   ignore column and per-class pixel counts
                   (region_cityscapes_visualize_minor.py:22-80)
  dom_w_gt         a dominant-label training item that carries the
                   precise GT too; 255 -> num_classes when the checkpoint
                   predicts ignore (region_cityscapes_dom_w_gt.py:44-85)
  dominant_sample  dominant labelling where each selected superpixel's
                   label is drawn in proportion to its class pixel counts
                   (region_cityscapes_dominant_all_sample.py:41-52,
                   torch.multinomial), by the Gumbel-max trick on log
                   counts

RegionStatsDataset splits an item as the port's file datasets do: `draw`
takes the random parameters in the calling process, in item order (the
crop of the train transform, and dominant_sample's Gumbel noise from one
RandomState(seed)), and `load` does the rest, in a worker process or not.
So the sampled maps do not depend on the number of workers: they are the
JAX package's with num_workers=0.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from mulactseg_tpu_torch.data.datasets import (
    _FileDataset,
    open_image,
    open_label,
    open_spx,
)
from mulactseg_tpu_torch.data.transforms import PairedTransform, normalize
from mulactseg_tpu_torch.tools.label_assignment import (
    _hist,
    boundaries_thick,
    dominant_label_for_image,
)


def superpixel_count_stats(gt: np.ndarray, spx: np.ndarray, nseg: int,
                           num_classes: int, selected: List[int],
                           ignore_idx: int = 255):
    """count_all: (sup_size_bin, num_class_bin). sup_size_bin is the pixel
    count of each id present in the map, ids ascending (np.unique's
    counts); num_class_bin[k] the number of distinct non-ignore GT classes
    inside selected[k] (0 for an empty or all-ignore superpixel)."""
    flat_spx = spx.reshape(-1)
    sup_size_bin = np.unique(flat_spx, return_counts=True)[1]
    hist = _hist(flat_spx, gt.reshape(-1), nseg, num_classes, ignore_idx)
    n_cls = (hist[:, :num_classes] > 0).sum(-1)
    num_class_bin = np.zeros((nseg,), np.int64)
    sel = np.asarray(selected, np.int64)
    if sel.size:
        num_class_bin[:sel.size] = n_cls[sel]
    return sup_size_bin, num_class_bin


def superpixel_composition(gt: np.ndarray, spx: np.ndarray, nseg: int,
                           num_classes: int, selected: List[int],
                           ignore_boundaries: bool = False,
                           ignore_idx: int = 255):
    """visualize_minor: (superpixel_cls (S, C+1) uint8 multi-hot, the
    ignore class in the last column; superpixel_size (S, C+1) int32 pixel
    counts, -1 where a class is absent). With ignore_boundaries the thick
    superpixel boundaries are left out first."""
    spx = np.asarray(spx)
    flat_spx = spx.reshape(-1).copy()
    if ignore_boundaries:
        flat_spx[boundaries_thick(spx).reshape(-1)] = nseg
    hist = _hist(flat_spx, np.asarray(gt).reshape(-1), nseg, num_classes,
                 ignore_idx)
    cls = np.zeros((nseg, num_classes + 1), np.uint8)
    size = np.full((nseg, num_classes + 1), -1, np.int32)
    sel = np.asarray(selected, np.int64)
    if sel.size:
        present = hist[sel] > 0
        cls[sel] = present.astype(np.uint8)
        size[sel] = np.where(present, hist[sel], -1).astype(np.int32)
    return cls, size


def _paint_sampled(gt, spx, nseg, num_classes, selected, gumbel,
                   generate_ignore=False, ignore_idx=255):
    """sample_dominant_map with its Gumbel noise (nseg, C+1) given."""
    flat_gt = np.asarray(gt).reshape(-1).copy()
    flat_spx = np.asarray(spx).reshape(-1)
    counts = _hist(flat_spx, flat_gt, nseg, num_classes,
                   ignore_idx).astype(np.float64)
    if not generate_ignore:
        counts[:, num_classes] = 0  # ignore never competes
    with np.errstate(divide="ignore"):
        draw = np.argmax(np.log(counts) + gumbel, axis=-1)
    sel = np.asarray(selected, np.int64)
    ignore_mask = flat_gt == ignore_idx
    if sel.size:
        for p, ok in zip(sel, counts[sel].sum(-1) > 0):
            if not ok:
                continue
            m = flat_spx == p
            if not generate_ignore:
                m &= ~ignore_mask
            flat_gt[m] = ignore_idx if draw[p] == num_classes else draw[p]
    if not generate_ignore:
        flat_gt[ignore_mask] = ignore_idx
    return flat_gt.reshape(np.asarray(gt).shape)


def sample_dominant_map(gt: np.ndarray, spx: np.ndarray, nseg: int,
                        num_classes: int, selected: List[int],
                        rng: np.random.RandomState,
                        generate_ignore: bool = False,
                        ignore_idx: int = 255):
    """dominant_all_sample: each selected superpixel painted with one class
    drawn with probability proportional to its pixel count (argmax of log
    counts plus Gumbel noise from rng, one (nseg, C+1) draw). Ignore
    pixels keep 255; with generate_ignore the ignore class competes and
    paints too."""
    return _paint_sampled(gt, spx, nseg, num_classes, selected,
                          rng.gumbel(size=(nseg, num_classes + 1)),
                          generate_ignore, ignore_idx)


class RegionStatsDataset(_FileDataset):
    """The four analysis item contracts over a RegionDatasetOr or
    RegionDatasetDominant base (mode = 'count_all' | 'visualize_minor' |
    'dom_w_gt' | 'dominant_sample'). count_all and visualize_minor are
    full-resolution analysis loaders; dom_w_gt and dominant_sample are
    training loaders that apply the base's train transform, rebuilt with
    their own pad values, before masking or sampling, as the reference
    does (region_cityscapes_dom_w_gt.py:65,
    region_cityscapes_dominant_all_sample.py:31)."""

    def __init__(self, cfg, base, mode: str, *,
                 pred_ignore: bool = False, generate_ignore: bool = False,
                 seed: int = 0):
        if mode not in LOADER_MODES.values():
            raise KeyError(mode)
        self.cfg = cfg
        self.base = base
        self.mode = mode
        self.pred_ignore = pred_ignore
        self.generate_ignore = generate_ignore
        self.seed = seed
        # the dominant_sample draws: a fresh label each epoch from one
        # advancing stream (the reference's worker RNG)
        self.rng = np.random.RandomState(seed)
        self.transform = None
        bt = getattr(base, "transform", None)
        if bt is not None and mode in ("dom_w_gt", "dominant_sample"):
            pads = ([cfg.ignore_idx, cfg.ignore_idx, cfg.nseg]
                    if mode == "dom_w_gt" else [cfg.ignore_idx, cfg.nseg])
            self.transform = PairedTransform(
                scale_range=bt.scale_range, crop_size=bt.crop_size,
                pad_values=pads, img_pad=bt.img_pad, hflip=bt.hflip,
                resize_to=bt.resize_to, seed=seed)

    # the active set reads and writes these on the base
    @property
    def im_idx(self):
        return self.base.im_idx

    @im_idx.setter
    def im_idx(self, v):
        self.base.im_idx = v

    @property
    def suppix(self):
        return self.base.suppix

    @suppix.setter
    def suppix(self, v):
        self.base.suppix = v

    def draw(self, index: int):
        """(transform parameters or None, Gumbel noise or None)."""
        params = super().draw(index)
        gumbel = (self.rng.gumbel(size=(self.cfg.nseg,
                                        self.cfg.num_classes + 1))
                  if self.mode == "dominant_sample" else None)
        return params, gumbel

    def load(self, index: int, drawn) -> Dict:
        cfg = self.cfg
        params, gumbel = drawn
        img_p, lbl_p, spx_p = self.base.im_idx[index]
        spx = open_spx(spx_p)
        selected = self.base.suppix.get(spx_p, [])
        fnames = self.base.im_idx[index]
        if self.mode == "count_all":
            gt = self.base.encode_fn(open_label(lbl_p))
            size_bin, ncls_bin = superpixel_count_stats(
                gt, spx, cfg.nseg, cfg.num_classes, selected,
                cfg.ignore_idx)
            return {"sup_size_bin": size_bin, "num_class_bin": ncls_bin,
                    "fnames": fnames}
        if self.mode == "visualize_minor":
            gt = self.base.encode_fn(open_label(lbl_p))
            cls, size = superpixel_composition(
                gt, spx, cfg.nseg, cfg.num_classes, selected,
                # no Config field sets it: the JAX package's getattr
                ignore_boundaries=getattr(cfg, "ignore_boundaries", False),
                ignore_idx=cfg.ignore_idx)
            return {"superpixel_info": (cls, size),
                    "superpixel": spx.astype(np.int32),
                    "target": gt.astype(np.int32), "fname": fnames}
        image_u8 = open_image(img_p)
        if self.mode == "dominant_sample":
            # the reference's order: the transform first, then a label
            # drawn for each selected superpixel from the counts in the
            # crop
            if self.transform is not None:
                image, (raw, spx) = self.transform(
                    image_u8, [open_label(lbl_p), spx], params)
                gt = self.base.encode_fn(raw)
            else:
                image = normalize(image_u8)
                gt = self.base.encode_fn(open_label(lbl_p))
            dom = _paint_sampled(gt, spx, cfg.nseg, cfg.num_classes,
                                 selected, gumbel, self.generate_ignore,
                                 cfg.ignore_idx)
            return {"images": image, "labels": dom.astype(np.int32),
                    "spx": np.asarray(spx).astype(np.int32),
                    "fnames": fnames}
        # dom_w_gt: the dominant map at full resolution, the pred_ignore
        # substitution before the transform and the selection mask after
        # it (region_cityscapes_dom_w_gt.py:44-80)
        if hasattr(self.base, "_gt_path"):
            # the dominant arm: lbl_p is the offline dominant file (raw
            # train ids), the precise GT is the gtFine file
            dom = np.asarray(open_label(lbl_p))
            precise = self.base.encode_fn(
                open_label(self.base._gt_path(lbl_p)))
        else:
            # the Or arm: lbl_p is the precise GT, its dominant map made
            # here as the offline tool makes it
            precise = self.base.encode_fn(open_label(lbl_p))
            dom = dominant_label_for_image(precise, spx, cfg.nseg,
                                           cfg.num_classes)
        if self.pred_ignore:
            dom = np.where(dom == cfg.ignore_idx, cfg.num_classes, dom)
            precise = np.where(precise == cfg.ignore_idx, cfg.num_classes,
                               precise)
        if self.transform is not None:
            image, (dom, precise, spx) = self.transform(
                image_u8, [dom, precise, spx], params)
        else:
            image = normalize(image_u8)
        mask = np.isin(spx, np.asarray(selected, np.int64))
        dom = np.where(mask, dom, cfg.ignore_idx)
        return {"images": image, "target": dom.astype(np.int32),
                "labels": np.asarray(precise).astype(np.int32),
                "spx": np.asarray(spx).astype(np.int32), "spmask": mask,
                "fnames": fnames}


# loader-name fragments (the reference's module names) -> mode
LOADER_MODES = {
    "count_all": "count_all",
    "visualize_minor": "visualize_minor",
    "dom_w_gt": "dom_w_gt",
    "dominant_all_sample": "dominant_sample",
}


def stats_mode_for_loader(loader: str) -> Optional[str]:
    for frag, mode in LOADER_MODES.items():
        if frag in loader:
            return mode
    return None
