"""Morphology over superpixel maps on the tensor's device: the port of
mulactseg_tpu/ops/morphology.py.

- binary_dilation3x3: 3x3 max pooling of a bool map (out-of-image
  neighbours ignored, lax.reduce_window's SAME with -inf);
- neighbor_ids_map / segment_adjacency: the k x k shifted copies of an
  edge-replicated id map, and the (S, S) adjacency they give;
- boundary_mask: pixels whose 3x3 neighbourhood (edge replicated) holds
  more than one id, skimage's find_boundaries(mode='thick'), compared
  as integers over the nine shifted copies.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def binary_dilation3x3(mask: torch.Tensor, iterations: int = 1
                       ) -> torch.Tensor:
    """3x3 full-kernel binary dilation of an (H, W) bool map."""
    x = mask.float()[None, None]
    for _ in range(iterations):
        x = F.max_pool2d(x, 3, stride=1, padding=1)
    return x[0, 0] > 0


def _edge_pad(spx: torch.Tensor, r: int) -> torch.Tensor:
    """(H, W) -> (H + 2r, W + 2r), the border rows and columns repeated."""
    H, W = spx.shape
    rows = torch.arange(-r, H + r, device=spx.device).clamp(0, H - 1)
    cols = torch.arange(-r, W + r, device=spx.device).clamp(0, W - 1)
    return spx[rows][:, cols]


def neighbor_ids_map(spx: torch.Tensor, k: int = 3) -> torch.Tensor:
    """(k*k, H, W): for each pixel, the ids inside its k x k neighbourhood
    (edge replicated), in row-major shift order."""
    H, W = spx.shape
    padded = _edge_pad(spx, k // 2)
    return torch.stack([padded[dy:dy + H, dx:dx + W]
                        for dy in range(k) for dx in range(k)])


def segment_adjacency(spx: torch.Tensor, num_segments: int, k: int = 3
                      ) -> torch.Tensor:
    """(S, S) bool: adj[a, b] iff some pixel of segment a has a pixel of
    segment b inside its k x k neighbourhood (a == a included). Ids >=
    num_segments (the invalid bucket) are dropped."""
    S = num_segments
    center = spx.reshape(-1).long()
    adj = torch.zeros(S * S, dtype=torch.bool, device=spx.device)
    for sh in neighbor_ids_map(spx, k).reshape(k * k, -1).long():
        keep = (center < S) & (sh < S) & (center >= 0) & (sh >= 0)
        adj[center[keep] * S + sh[keep]] = True
    return adj.view(S, S)


def boundary_mask(spx: torch.Tensor) -> torch.Tensor:
    """(H, W) bool: superpixel boundaries, pixels whose 3x3 neighbourhood
    holds more than one id."""
    ids = neighbor_ids_map(spx, 3)
    return ids.amax(0) != ids.amin(0)
