"""The benchmark's fixed arithmetic: the card's peaks, a kernel's bound,
the bytes and operations that the loss kernels (K1-K4) and the segment max
(K5) need for given inputs, the reduction of a profiler trace to device
spans, busy time, kernel kinds and idle gaps, the percentile of step
times, and the FLOPs of a convolution's backward pass. The byte counts are those of the port's chip_smoke.py
(`kernel_checks`, `bound`); the span arithmetic is its `device_spans` and
`busy_window`; the kinds are its `profile_steps` table.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

LOSS_KERNELS = ("pixel_ce_", "ssm_")
K5_KERNELS = ("seg_max_",)
KINDS = (  # first match wins
    ("loss", LOSS_KERNELS + ("prereduce", "seg_max_")),
    ("conv", ("conv", "gemm", "xmma", "cutlass", "cudnn", "wgrad", "dgrad",
              "sm90", "Conv")),
    ("optimizer", ("multi_tensor", "adam", "Adam")),
    ("norm_eltwise", ("elementwise", "copy", "Memcpy", "Memset", "fill",
                      "reduce", "Reduce", "batch_norm", "bn_", "cast",
                      "where", "softmax", "upsample", "pool", "cat",
                      "index", "scatter", "gather")),
)


def bound_s(nbytes: float, nops: float) -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and float32 operations over the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S)


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                        _padding, _dilation, transposed, _output_padding,
                        _groups, output_mask, out_shape=None, **_) -> int:
    """FLOPs of `aten.convolution_backward` from its shapes: each gradient
    asked for (input, weight) costs what the forward does, 2 x batch x the
    weight's elements (Cout x Cin/groups x k^2) x the positions of the
    non-transposed side. torch.utils.flop_counter's own formula counts a
    grouped convolution's weight gradient `groups` times too large."""
    spatial = x_shape[2:] if transposed else grad_out_shape[2:]
    fwd = 2 * x_shape[0] * math.prod(w_shape) * math.prod(spatial)
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def popcount(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    out = np.zeros(v.shape, np.int64)
    for b in range(32):
        out += (v >> b) & 1
    return out


def loss_kernel_bounds(bits: np.ndarray, spx: np.ndarray,
                       target: np.ndarray, C: int) -> Dict[str, float]:
    """Seconds of bound of K1 (pixel_ce_fwd), K2 (pixel_ce_bwd), K3
    (ssm_fwd) and K4 (ssm_bwd) on one stage-1 batch: bits, spx (B, H, W),
    target (B, S, >=C). Inputs are counted once, outputs once, the logits
    only at the pixels that need them: K1 and K2 at pixels with a candidate,
    K3 at multi-hot pixels, K4 at the live (segment, class) entries'
    argmax pixels, counted as the entries (an entry's argmax pixel is
    shared by at most a few)."""
    B, H, W = bits.shape
    S = target.shape[1]
    P = B * H * W
    row = C * 4
    n = popcount(bits & ((1 << C) - 1))
    n_live = int((n > 0).sum())
    n_valid = int((n > 1).sum())
    multi = n > 1
    present = np.zeros((B, S), bool)
    for b in range(B):
        ids = spx[b][multi[b]]
        present[b, ids[ids < S]] = True
    entries = int(((target[..., :C] > 0.5) & present[..., None]).sum())
    SC = B * S
    return {
        "pixel_ce_fwd": bound_s(P * 4 + n_live * row + 16, 8 * n_live * C),
        "pixel_ce_bwd": bound_s(P * 4 + n_live * row + P * row + 8,
                                12 * n_live * C),
        "ssm_fwd": bound_s(P * 4 + n_valid * row + SC * C * 8,
                           8 * n_valid * C),
        "ssm_bwd": bound_s(P * row + 3 * SC * C * 4 + entries * row,
                           12 * entries * C),
    }


def k5_bound(n_valid: int, P: int, S: int, C: int) -> float:
    """Seconds of bound of K5 (seg_max_fwd) over (P, C) float32 values, ids
    (P,), n_valid pixels in a segment, (S, C) maxima and argmaxes out."""
    return bound_s(P * 4 + n_valid * C * 4 + S * C * 8, n_valid * C)


def kernel_of(name: str) -> str:
    """The wrapper whose launch ran a device kernel: pixel_ce_fwd,
    pixel_ce_bwd, ssm_fwd (span and decode), ssm_bwd, seg_max_fwd; '' for
    others."""
    if "pixel_ce_fwd" in name:
        return "pixel_ce_fwd"
    if "pixel_ce_bwd" in name:
        return "pixel_ce_bwd"
    if "ssm_bwd" in name:
        return "ssm_bwd"
    if "ssm_span" in name or "ssm_decode" in name:
        return "ssm_fwd"
    if "seg_max_" in name:
        return "seg_max_fwd"
    return ""


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def union(spans: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) spans."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def gaps(spans: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle (start, end) intervals of [lo, hi] that no span covers."""
    out, cur = [], lo
    for s, e in sorted(spans):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all values, nearest rank."""
    v = sorted(values)
    k = max(0, math.ceil(q / 100.0 * len(v)) - 1)
    return v[k]
