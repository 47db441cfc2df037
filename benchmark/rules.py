"""Traffic rules, copied so that the yardstick stays fixed: the jittered-grid
superpixels, the multi-hot of the classes under each superpixel, the
per-pixel candidate bitmask and Pillow's nearest-resize index. They are the
rules of `mulactseg_tpu_torch/data/synthetic.py` (`irregular_superpixels`,
`multi_hot_from_gt`), `losses/fused.py` (`pixel_target_bits`) and
`data/transforms.py` (`_pil_nearest_index`), written again here so that a
change to the program cannot move what the benchmark feeds it.
"""

from __future__ import annotations

import math

import numpy as np


def irregular_superpixels(H: int, W: int, nseg: int,
                          rng: np.random.RandomState) -> np.ndarray:
    """(H, W) int32 ids 0..nseg-1: contiguous irregular cells with SEEDS-like
    size statistics, a grid whose band edges are jittered by `rng`."""
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


def blobby_labels(rng: np.random.RandomState, H: int, W: int,
                  num_classes: int, cells_y: int, cells_x: int,
                  ignore_share: float, ignore_value: int = 255) -> np.ndarray:
    """(H, W) int32 label map of cells_y x cells_x blocks, each one class
    drawn uniformly, or `ignore_value` with probability ignore_share."""
    grid = rng.randint(0, num_classes, size=(cells_y, cells_x))
    grid = np.where(rng.rand(cells_y, cells_x) < ignore_share, ignore_value,
                    grid)
    ys = np.arange(H) * cells_y // H
    xs = np.arange(W) * cells_x // W
    return grid.astype(np.int32)[ys][:, xs]


def multi_hot_from_gt(gt: np.ndarray, spx: np.ndarray, nseg: int,
                      num_classes: int, ignore_idx: int = 255) -> np.ndarray:
    """(nseg, C+1) float32 multi-hot of the classes present in each
    superpixel; ignore pixels feed the last channel."""
    g = np.where(gt == ignore_idx, num_classes, gt).astype(np.int32)
    flat_idx = spx.reshape(-1).astype(np.int32) * (num_classes + 1) \
        + g.reshape(-1)
    counts = np.bincount(flat_idx, minlength=nseg * (num_classes + 1))
    return (counts.reshape(nseg, num_classes + 1) > 0).astype(np.float32)


def pixel_target_bits(target: np.ndarray, spx: np.ndarray,
                      spmask: np.ndarray) -> np.ndarray:
    """(S, C<=31) multi-hot + (H, W) ids + (H, W) selected mask -> (H, W)
    int32 candidate bitmask, 0 where a pixel is not selected. Padding ids
    (nseg) are clipped for the lookup and never selected."""
    C = target.shape[-1]
    if C > 31:
        raise ValueError(f"at most 31 classes fit an int32 bitmask, got {C}")
    weights = 1 << np.arange(C, dtype=np.int64)
    seg_bits = ((target > 0.5).astype(np.int64) * weights).sum(-1)
    spx_c = np.minimum(spx, seg_bits.shape[0] - 1)
    return (seg_bits[spx_c] * spmask).astype(np.int32)


def pil_nearest_index(n_src: int, n_out: int) -> np.ndarray:
    """Source index per output position of Pillow's NEAREST resize (the
    sampling centre accumulated addition by addition, then truncated)."""
    a1 = n_src / n_out
    xs = np.empty(n_out)
    x = a1 * 0.5
    for k in range(n_out):
        xs[k] = x
        x += a1
    return np.minimum(xs.astype(np.int64), n_src - 1)
