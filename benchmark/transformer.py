"""What the transformer cells' per-layer metrics read from the traced
stretch: the attention kernels of F.scaled_dot_product_attention and the
LayerNorm kernels, found by name, and the attention's bound from the
port's `sdpa` counters (ops/_build.LAUNCHES, models/segformer.attention).
"""

from __future__ import annotations

from typing import Dict, Optional

from benchmark import yardstick

# kernel names on the H100 (torch 2.11, CUDA 12.8). The cuDNN backend
# runs the cell's bf16 attention: one
# cudnn_generated_fort_native_sdpa_sm90_flash_fprop_* a call forward,
# cudnn::fusion::compute_dot_do_o_specialized and one ..._flash_bprop_*
# backward; the flash backend's flash_fwd_* and flash_bwd_*, the efficient
# backend's fmha_cutlassF_* and fmha_cutlassB_*, where they run instead.
ATTN_FORWARD = ("sdpa_sm90_flash_fprop", "flash_fwd_", "fmha_cutlassF")
ATTN_BACKWARD = ("sdpa_sm90_flash_bprop", "compute_dot_do_o", "flash_bwd_",
                 "fmha_cutlassB")
# vectorized_layer_norm_kernel, layer_norm_grad_input_kernel_vectorized,
# GammaBetaBackwardCUDAKernelTemplate (and the unvectorised paths' names)
LAYER_NORM = ("layer_norm", "LayerNorm", "GammaBetaBackward")


def _is(name: str, keys) -> bool:
    return any(k in name for k in keys)


def attn_s(ctx: Dict) -> Optional[float]:
    """Device seconds of the attention kernels, forward and backward, over
    the traced stretch; None unless their forward kernels number the
    port's `sdpa` calls."""
    spans = ctx.get("prof_spans")
    calls = ctx.get("launches", {}).get("sdpa")
    if not spans or not calls:
        return None
    if sum(_is(n, ATTN_FORWARD) for _, _, n in spans) != calls:
        return None
    return sum(e - s for s, e, n in spans
               if _is(n, ATTN_FORWARD) or _is(n, ATTN_BACKWARD)) or None


def attn_bound_s(ctx: Dict) -> Optional[float]:
    """The least time the traced stretch's attention could take, forward
    and backward, what the data needs with bf16 operands: FLOPs 4 B h N M
    d forward (q k^T and p v) and 8 backward (dq, dk, dv, dp; flash's
    recomputation of the scores not counted) over 989 TFLOP/s; bytes
    2 x (Q, K, V, O once forward; Q, K, V, O, dO read and dQ, dK, dV
    written backward) = 2 x 6 B h (N + M) d over 3.35 TB/s; the larger."""
    launches = ctx.get("launches", {})
    bhnmd, bhnpmd = launches.get("sdpa.bhnmd"), launches.get("sdpa.bhnpmd")
    if not bhnmd or not bhnpmd:
        return None
    flops = (4 + 8) * bhnmd
    nbytes = 2 * (2 + 4) * bhnpmd
    return max(nbytes / yardstick.HBM_BYTES_PER_S,
               flops / yardstick.BF16_FLOPS_PER_S)


def layer_norm_s(ctx: Dict) -> Optional[float]:
    """Device seconds of the LayerNorm kernels, forward and backward."""
    spans = ctx.get("prof_spans")
    if not spans:
        return None
    return sum(e - s for s, e, n in spans if _is(n, LAYER_NORM)) or None
