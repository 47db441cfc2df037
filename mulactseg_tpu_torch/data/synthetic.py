"""Synthetic in-memory fixture dataset: the port's copy of
mulactseg_tpu/data/synthetic.py (SyntheticRegionDataset, the superpixel
makers and the multi-hot annotation).

Blobby GT label maps, grid superpixels and the derived multi-hot
per-superpixel annotations, exposed through the region-dataset surface
(im_idx / suppix / multi_hot_cls / id_to_index / isselected) that the
active set mutates. The draws from the seed are the JAX package's, so one
seed gives one dataset in both; images come out channel-first (3, H, W),
the port's layout.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from mulactseg_tpu_torch.data.transforms import normalize
from mulactseg_tpu_torch.losses.fused import pixel_target_bits


def _blobby_labels(rng, H, W, num_classes, cells=4):
    grid = rng.randint(0, num_classes, size=(cells, cells)).astype(np.uint8)
    ys = (np.arange(H) * cells // H)
    xs = (np.arange(W) * cells // W)
    return grid[np.ix_(ys, xs)]


def grid_superpixels(H: int, W: int, nseg: int) -> np.ndarray:
    """Regular-grid superpixels: ids 0..nseg-1 tiling the image."""
    g = int(math.floor(math.sqrt(nseg)))
    gy = g
    gx = nseg // g
    ys = np.minimum((np.arange(H) * gy // H), gy - 1)
    xs = np.minimum((np.arange(W) * gx // W), gx - 1)
    return (ys[:, None] * gx + xs[None, :]).astype(np.int32)


def multi_hot_from_gt(gt: np.ndarray, spx: np.ndarray, nseg: int,
                      num_classes: int, ignore_idx: int = 255) -> np.ndarray:
    """(S, C+1) multi-hot of the classes present in each superpixel;
    ignore pixels feed the last channel."""
    g = np.where(gt == ignore_idx, num_classes, gt).astype(np.int64)
    flat_idx = spx.reshape(-1) * (num_classes + 1) + g.reshape(-1)
    counts = np.bincount(flat_idx, minlength=nseg * (num_classes + 1))
    return (counts.reshape(nseg, num_classes + 1) > 0).astype(np.float32)


class SyntheticRegionDataset:
    """split: 'active-label' -> training items (images, labels, target
    multi-hot, target_bits, spx, spmask over the selected superpixels);
    'active-ulabel' -> pool items (images, spx, labels = the multi-hot);
    'val' -> (images, GT labels). Images are normalised float32
    (3, H, W). small_nseg adds 'spx_small', a finer grid, to training
    items (the hierarchy criteria); async_views adds the weak view's keys
    ('images_weak', 'spx_weak', 'spmask_weak', 'spx_small_weak'), copies
    of the item's own, as the JAX fixture makes them. The JAX fixture's
    transform option serves no caller of the port and is left out."""

    def __init__(self, *, n_images=4, H=64, W=64, num_classes=5, nseg=16,
                 split="active-label", seed=0, ignore_frac=0.05,
                 small_nseg=None, async_views=False):
        self.small_nseg = small_nseg
        self.async_views = async_views
        self.nseg = nseg
        self.num_classes = num_classes
        self.split = split
        self.H, self.W = H, W
        rng = np.random.RandomState(seed)
        self.images = []
        self.gts = []
        spx_map = grid_superpixels(H, W, nseg)
        self.spx_map = spx_map
        self.spx_small_map = (grid_superpixels(H, W, small_nseg)
                              if small_nseg else None)
        mh = []
        self.im_idx: List[List[str]] = []
        self.suppix: Dict[str, List[int]] = {}
        self.id_to_index: Dict[str, int] = {}
        for i in range(n_images):
            img = rng.randint(0, 255, size=(H, W, 3)).astype(np.uint8)
            gt = _blobby_labels(rng, H, W, num_classes)
            ign = rng.rand(H, W) < ignore_frac
            gt = np.where(ign, 255, gt).astype(np.int32)
            self.images.append(img)
            self.gts.append(gt)
            mh.append(multi_hot_from_gt(gt, spx_map, nseg, num_classes))
            key = [f"img_{i}.png", f"lbl_{i}.png", f"spx_{i}.pkl"]
            self.im_idx.append(key)
            self.suppix[key[2]] = np.unique(spx_map).tolist()
            self.id_to_index[f"lbl_{i}"] = i
        self.multi_hot_cls = np.stack(mh)  # (N, S, C+1)
        self.isselected = np.zeros(self.multi_hot_cls.shape[:-1], np.float32)

    def __len__(self):
        return len(self.im_idx)

    def __getitem__(self, index):
        key = self.im_idx[index]
        gidx = self.id_to_index[key[1].split(".")[0]]
        im = normalize(self.images[gidx])
        gt = self.gts[gidx]
        sp = self.spx_map.astype(np.int32)
        target = self.multi_hot_cls[gidx]
        if self.split == "val":
            return {"images": im, "labels": gt.astype(np.int32),
                    "fnames": key}
        if self.split == "active-ulabel":
            return {"images": im, "spx": sp, "labels": target,
                    "fnames": key}
        # active-label (training)
        spmask = np.isin(sp, self.suppix.get(key[2], []))
        sample = {"images": im, "labels": gt.astype(np.int32),
                  "target": target.astype(np.float32), "spx": sp,
                  "spmask": spmask, "fnames": key}
        if target.shape[-1] <= 31:
            sample["target_bits"] = pixel_target_bits(target, sp, spmask)
        if self.spx_small_map is not None:
            sample["spx_small"] = self.spx_small_map.astype(np.int32)
        if self.async_views:
            sample["images_weak"] = im
            sample["spx_weak"] = sp
            sample["spmask_weak"] = spmask
            if self.spx_small_map is not None:
                sample["spx_small_weak"] = sample["spx_small"]
        return sample


def irregular_superpixels(H: int, W: int, nseg: int,
                          rng: "np.random.RandomState") -> np.ndarray:
    """Jittered-grid superpixels: contiguous irregular cells with
    SEEDS-like size statistics (compact blobs of ~H*W/nseg pixels, raster
    runs of ~sqrt(H*W/nseg) px). Same draws from `rng` as the JAX
    package's copy, so one seed gives one map in both."""
    gy = int(math.floor(math.sqrt(nseg)))
    gx = nseg // gy

    def bounds(n, size):
        w = 0.6 + 0.8 * rng.rand(n)
        edges = np.round(np.cumsum(w) / w.sum() * size).astype(np.int64)
        return np.concatenate([[0], edges])

    ybounds = bounds(gy, H)
    yband = np.zeros(H, np.int64)
    for i in range(gy):
        yband[ybounds[i]:ybounds[i + 1]] = i
    out = np.zeros((H, W), np.int32)
    for i in range(gy):
        xb = bounds(gx, W)
        xband = np.zeros(W, np.int64)
        for j in range(gx):
            xband[xb[j]:xb[j + 1]] = j
        rows = yband == i
        out[rows] = (i * gx + xband)[None, :]
    return out
