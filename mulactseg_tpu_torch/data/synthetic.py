"""Synthetic superpixel maps (the port's copies of
mulactseg_tpu/data/synthetic.py:29 grid_superpixels and :154
irregular_superpixels)."""

from __future__ import annotations

import math

import numpy as np


def grid_superpixels(H: int, W: int, nseg: int) -> np.ndarray:
    """Regular-grid superpixels: ids 0..nseg-1 tiling the image."""
    g = int(math.floor(math.sqrt(nseg)))
    gy = g
    gx = nseg // g
    ys = np.minimum((np.arange(H) * gy // H), gy - 1)
    xs = np.minimum((np.arange(W) * gx // W), gx - 1)
    return (ys[:, None] * gx + xs[None, :]).astype(np.int32)


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
