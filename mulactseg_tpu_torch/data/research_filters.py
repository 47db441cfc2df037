"""Research-loader multi-hot rewrites: the port's copy of
mulactseg_tpu/data/research_filters.py.

The reference's *_tinyfilter_gt / *_ratiofilter_gt / *_ratiosample_gt /
*_dominantsample_gt / *_toponebase_gt loaders are RegionCityscapesOr
subclasses whose only change is a rewrite of the loaded multi_hot_cls
tensor from a GT class-wise superpixel-size tensor `sp_gt_size.npy`
(N, nseg, C+1; -1 rows mark absent superpixels), which
tools/label_assignment writes. Here they are numpy functions applied once
when the dataset is built (RegionDatasetOr(multihot_transform=...)); the
sampled rewrites draw from RandomState(seed) in the JAX package's order,
so one seed gives one tensor in both.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-12


def _ratios(gt_sizes: np.ndarray) -> np.ndarray:
    """Class-share ratios per superpixel; -1 invalid entries count as 0
    (region_cityscapes_or_tensor_ratiofilter_gt.py:44-49)."""
    sz = np.where(gt_sizes == -1, 0, gt_sizes).astype(np.float64)
    return sz / (sz.sum(axis=-1, keepdims=True) + EPS)


def tinyfilter(multi_hot: np.ndarray, gt_sizes: np.ndarray,
               filter_size: int) -> np.ndarray:
    """Drop candidate classes whose GT pixel count inside the superpixel is
    below `filter_size`, then force the largest class back on
    (region_cityscapes_or_tensor_tinyfilter_gt.py:33-50)."""
    out = np.where(gt_sizes < filter_size, 0, multi_hot).astype(
        multi_hot.dtype)
    n, s, c = gt_sizes.shape
    flat = out.reshape(-1, c)
    top = gt_sizes.reshape(-1, c).argmax(1)
    flat[np.arange(n * s), top] = 1
    return flat.reshape(n, s, c)


def tinyfilter_recommend(multi_hot: np.ndarray, gt_sizes: np.ndarray,
                         filter_size: int) -> np.ndarray:
    """Like tinyfilter, but small classes are dropped only in superpixels
    that would end up (near-)single-class anyway — fewer than 2 classes
    above the size threshold
    (region_cityscapes_or_tensor_tinyfilter_recommend_gt.py:33-58)."""
    small = gt_sizes < filter_size
    dominant = (~small).sum(-1) < 2
    out = np.where(small & dominant[..., None], 0, multi_hot).astype(
        multi_hot.dtype)
    n, s, c = gt_sizes.shape
    flat = out.reshape(-1, c)
    top = gt_sizes.reshape(-1, c).argmax(1)
    flat[np.arange(n * s), top] = 1
    return flat.reshape(n, s, c)


def ratiofilter(multi_hot: np.ndarray, gt_sizes: np.ndarray,
                filter_ratio: float) -> np.ndarray:
    """Drop candidate classes whose within-superpixel GT share is below
    `filter_ratio` (region_cityscapes_or_tensor_ratiofilter_gt.py:33-51)."""
    return np.where(_ratios(gt_sizes) < filter_ratio, 0,
                    multi_hot).astype(multi_hot.dtype)


def _multinomial_no_replacement(ratios: np.ndarray, k: int,
                                rng: np.random.RandomState) -> np.ndarray:
    """Row-wise sample k class indices without replacement, probability
    proportional to ratio (the torch.multinomial call) via Gumbel top-k."""
    g = rng.gumbel(size=ratios.shape)
    keys = np.log(ratios + EPS) + g
    return np.argsort(-keys, axis=1)[:, :k]


def ratiosample(multi_hot: np.ndarray, gt_sizes: np.ndarray,
                filter_ratio: float,
                rng: np.random.RandomState) -> np.ndarray:
    """Sample candidate classes by GT share until the cumulative share
    exceeds 1 - filter_ratio; rows with zero share get nothing
    (region_cityscapes_or_tensor_ratiosample_gt.py:33-69)."""
    n, s, c = multi_hot.shape
    ratios = _ratios(gt_sizes).reshape(-1, c)
    k = int(multi_hot.sum(axis=2).max())
    picks = _multinomial_no_replacement(ratios, k, rng)
    out = multi_hot.reshape(-1, c).copy()
    rows = np.arange(ratios.shape[0])
    cum = np.zeros(ratios.shape[0])
    assign = np.ones(ratios.shape[0], bool)
    for count in range(k):
        cum += ratios[rows, picks[:, count]]
        assign[cum == 0] = False
        out[rows, picks[:, count]] = assign.astype(out.dtype)
        assign[(1.0 - filter_ratio) < cum] = False
    return out.reshape(n, s, c)


def dominantsample(multi_hot: np.ndarray, gt_sizes: np.ndarray,
                   rng: np.random.RandomState) -> np.ndarray:
    """One class per superpixel, sampled by GT share; the rest cleared
    (region_cityscapes_or_tensor_dominantsample_gt.py:33-68)."""
    n, s, c = multi_hot.shape
    ratios = _ratios(gt_sizes).reshape(-1, c)
    picks = _multinomial_no_replacement(ratios, 1, rng)[:, 0]
    rows = np.arange(ratios.shape[0])
    assign = ratios[rows, picks] > 0
    out = np.zeros((n * s, c), multi_hot.dtype)
    out[rows, picks] = assign.astype(out.dtype)
    return out.reshape(n, s, c)


def toponebase(multi_hot: np.ndarray, gt_sizes: np.ndarray) -> np.ndarray:
    """One-hot at the largest GT class — the dominant-label oracle baseline
    (region_cityscapes_or_tensor_toponebase_gt.py:31-38)."""
    n, s, c = multi_hot.shape
    top = gt_sizes.reshape(-1, c).argmax(1)
    out = np.zeros((n * s, c), multi_hot.dtype)
    out[np.arange(n * s), top] = 1
    return out.reshape(n, s, c)


def apply_multihot_transform(name: str, multi_hot: np.ndarray,
                             gt_sizes: np.ndarray, cfg,
                             seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if name == "tinyfilter_recommend":
        return tinyfilter_recommend(multi_hot, gt_sizes,
                                    cfg.multihot_filter_size)
    if name == "tinyfilter":
        return tinyfilter(multi_hot, gt_sizes, cfg.multihot_filter_size)
    if name == "ratiofilter":
        return ratiofilter(multi_hot, gt_sizes, cfg.multihot_filter_ratio)
    if name == "ratiosample":
        return ratiosample(multi_hot, gt_sizes, cfg.multihot_filter_ratio,
                           rng)
    if name == "dominantsample":
        return dominantsample(multi_hot, gt_sizes, rng)
    if name == "toponebase":
        return toponebase(multi_hot, gt_sizes)
    raise KeyError(f"unknown multihot transform {name!r}")
