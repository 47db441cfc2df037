"""FastBatchNorm's training pass: the batch statistics over (N, H, W), the
running-statistics update and the affine y = x * a + b in x's dtype, with
its gradient (models/layers.FastBatchNorm, the port of the JAX package's
FastBatchNorm, mulactseg_tpu/models/layers.py:43-96, which XLA fuses).

On the card the pass is six kernels of csrc/batch_norm.cu, three forward
(bn_stats, bn_finalize, bn_apply) and three backward (bn_bwd_stats,
bn_bwd_finalize, bn_dx), each counted in ops/_build.LAUNCHES under its
name: the activation is read in bf16 (or float32) straight into float32
sums, with no float32 copy, and the backward saves x itself. An NCHW or
channels-last activation keeps its layout in y and dx. CPU tensors
take the plain version below, which is the port's FastBatchNorm as it
was written in PyTorch ops; CUDA tensors take the kernels or raise.
Under data parallelism (parallel/mesh.py) both sides normalise with the
global batch's statistics.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from mulactseg_tpu_torch.ops import _build
from mulactseg_tpu_torch.parallel import mesh

# the blocks a statistics pass aims to put on each SM, the least elements
# a statistics block takes, and the flat elements an apply or dx block
# takes (csrc/batch_norm.cu: multiples of 64)
BLOCKS_PER_SM = 8
MIN_SPLIT = 4096
APPLY_CHUNK = 8192
MAX_ELEMENTS = 2 ** 31  # csrc/batch_norm.cu kMaxElements
KERNELS = ("bn_stats", "bn_finalize", "bn_apply", "bn_bwd_stats",
           "bn_bwd_finalize", "bn_dx")


def affine(x, m, v, weight, bias, eps: float):
    """y = x * a + b in x's dtype, a = weight * rsqrt(v + eps) and
    b = bias - m * a computed in float32."""
    a = weight * torch.rsqrt(v + eps)
    b = bias - m * a
    dt = x.dtype
    return x * a.to(dt)[None, :, None, None] + b.to(dt)[None, :, None, None]


def batch_norm_plain(x, weight, bias, running_mean, running_var,
                     momentum: float, eps: float):
    """The training pass in PyTorch ops, differentiable by autograd:
    global-batch statistics under data parallelism (one (2, C)
    all-reduce of [sum x, sum x^2]), the running statistics updated in
    place, the affine in x's dtype."""
    n = x.numel() // x.shape[1] * mesh.world()
    xf = x.float()
    sums = mesh.all_reduce_sum(torch.stack(
        [xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))]))
    m = sums[0] / n
    v = torch.clamp(sums[1] / n - m * m, min=0.0)
    with torch.no_grad():
        running_mean.mul_(1.0 - momentum).add_(momentum * m.detach())
        running_var.mul_(1.0 - momentum).add_(momentum * v.detach())
    return affine(x, m, v, weight, bias, eps)


def plan(C: int, L: int, sms: int, per: int = 1) -> Tuple[int, int]:
    """(splits, chunk) of a statistics pass over C channels of L = N * H * W
    positions each, a block taking `per` channels (1 for NCHW, 32 units
    of them for channels-last): about BLOCKS_PER_SM blocks on each of
    `sms` SMs in all, no block below MIN_SPLIT elements unless the
    channels are smaller, the chunk a multiple of 64 positions (so splits
    start 16-byte aligned where the planes do)."""
    want = -(-BLOCKS_PER_SM * sms // -(-C // per))
    splits = max(1, min(want, L // -(-MIN_SPLIT // per), 65535))
    chunk = -(-L // splits)
    chunk = -(-chunk // 64) * 64
    return -(-L // chunk), chunk


_VP, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)
# bn_stats(x, part, C, HW, L, chunk, splits, wide, rows, bf16, stream)
# bn_finalize(part, splits, C, n, eps, keep, momentum, bf16, w, beta,
#             rmean, rvar, stats, stream)
# bn_apply(x, y, stats, C, HW, total, chunk, wide, rows, bf16, stream)
# bn_bwd_stats(x, g, part, C, HW, L, chunk, splits, wide, rows, bf16,
#              stream)
# bn_bwd_finalize(part, gpart, splits, C, n, w, stats, dw, db, coef,
#                 stream)
# bn_dx(x, g, dx, stats, coef, C, HW, total, chunk, wide, rows, bf16,
#       stream)
_ARGTYPES = {
    "bn_stats": [_VP, _VP, _I, _LL, _LL, _LL, _I, _I, _I, _I, _VP],
    "bn_finalize": [_VP, _I, _I, _F, _F, _F, _F, _I] + [_VP] * 6,
    "bn_apply": [_VP, _VP, _VP, _I, _LL, _LL, _LL, _I, _I, _I, _VP],
    "bn_bwd_stats": [_VP, _VP, _VP, _I, _LL, _LL, _LL, _I, _I, _I, _I, _VP],
    "bn_bwd_finalize": [_VP, _VP, _I, _I, _F] + [_VP] * 6,
    "bn_dx": [_VP] * 5 + [_I, _LL, _LL, _LL, _I, _I, _I, _VP],
}


def _launch(name: str, *args) -> None:
    lib = _build.load("batch_norm", _ARGTYPES)
    _build.check(getattr(lib, name)(*args), name)
    _build.LAUNCHES[name] += 1


def _aligned(*ts) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in ts))


def _layout(t, rows: bool):
    """t dense in the activation's layout: channels-last (rows) or NCHW."""
    return t.contiguous(memory_format=torch.channels_last if rows
                        else torch.contiguous_format)


def _reduction(x, rows: bool, sms: int):
    """(splits, chunk, wide) of the statistics passes over x: 16-byte units
    where x is aligned and each plane (NCHW) or row (channels-last) holds
    whole ones."""
    N, C, H, W = x.shape
    unit = 8 if x.dtype == torch.bfloat16 else 4
    wide = _aligned(x) and (C if rows else H * W) % unit == 0
    splits, chunk = plan(C, N * H * W, sms,
                         32 * (unit if wide else 1) if rows else 1)
    return splits, chunk, int(wide)


def _check(x, params):
    if x.dim() != 4:
        raise ValueError(f"want an (N, C, H, W) activation, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"want a bf16 or float32 activation, got {x.dtype}")
    if x.numel() > MAX_ELEMENTS:
        raise ValueError(f"the kernels index in 32 bits: at most "
                         f"{MAX_ELEMENTS} elements, got {x.numel()}")
    C = x.shape[1]
    for t in params:
        if t.device != x.device or t.dtype != torch.float32 \
                or t.shape != (C,) or not t.is_contiguous():
            raise ValueError(f"want contiguous float32 ({C},) parameters "
                             f"and statistics on {x.device}")


class _TrainBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps):
        _check(x, (weight, bias, running_mean, running_var))
        # a channels-last activation stays channels-last, as its output
        # and gradient do (SegFormer's decoder hands its BN one)
        rows = not x.is_contiguous() and x.is_contiguous(
            memory_format=torch.channels_last)
        x = _layout(x, rows)
        N, C, H, W = x.shape
        HW, L = H * W, N * H * W
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        splits, chunk, wide = _reduction(x, rows, sms)
        stream = _build.stream_ptr(x.device)
        bf16 = int(x.dtype == torch.bfloat16)
        part = torch.empty(2, splits, C, device=x.device)
        _launch("bn_stats", x.data_ptr(), part.data_ptr(), C, HW, L, chunk,
                splits, wide, int(rows), bf16, stream)
        # under data parallelism the partials of every rank (the same
        # splits on each) summed, so the statistics are the global batch's
        part = mesh.all_reduce_sum(part)
        n = float(L * mesh.world())
        stats = torch.empty(6, C, device=x.device)
        _launch("bn_finalize", part.data_ptr(), splits, C, n, eps,
                1.0 - momentum, momentum, bf16, weight.data_ptr(),
                bias.data_ptr(), running_mean.data_ptr(),
                running_var.data_ptr(), stats.data_ptr(), stream)
        y = torch.empty_like(x)
        _launch("bn_apply", x.data_ptr(), y.data_ptr(), stats.data_ptr(), C,
                HW, x.numel(), APPLY_CHUNK, _aligned(x, y), int(rows), bf16,
                stream)
        ctx.save_for_backward(x, weight, stats)
        ctx.plan, ctx.rows, ctx.n = (splits, chunk, wide), rows, n
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        if dy.dtype != x.dtype:
            raise TypeError(f"gradient {dy.dtype} for a {x.dtype} output")
        rows = ctx.rows
        dy = _layout(dy, rows)
        N, C, H, W = x.shape
        HW, L = H * W, N * H * W
        splits, chunk, wide = ctx.plan
        stream = _build.stream_ptr(x.device)
        bf16 = int(x.dtype == torch.bfloat16)
        part = torch.empty(2, splits, C, device=x.device)
        _launch("bn_bwd_stats", x.data_ptr(), dy.data_ptr(), part.data_ptr(),
                C, HW, L, chunk, splits, wide & _aligned(dy), int(rows), bf16,
                stream)
        # dw and dbias from this rank's sums (mesh.all_reduce_grads sums
        # them afterwards), dx's coefficients from the global ones, as the
        # gradient of the forward's all-reduce gives them
        gpart = mesh.all_reduce_sum(part)
        dw = torch.empty(C, device=x.device)
        db = torch.empty(C, device=x.device)
        coef = torch.empty(2, C, device=x.device)
        _launch("bn_bwd_finalize", part.data_ptr(), gpart.data_ptr(), splits,
                C, ctx.n, weight.data_ptr(), stats.data_ptr(), dw.data_ptr(),
                db.data_ptr(), coef.data_ptr(), stream)
        dx = torch.empty_like(x)
        _launch("bn_dx", x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                stats.data_ptr(), coef.data_ptr(), C, HW, x.numel(),
                APPLY_CHUNK, _aligned(x, dy, dx), int(rows), bf16, stream)
        return dx, dw, db, None, None, None, None


def batch_norm_train(x, weight, bias, running_mean, running_var,
                     momentum: float, eps: float):
    """FastBatchNorm's training pass on x (N, C, H, W): the output in x's
    dtype, the running statistics updated in place. CPU tensors take
    batch_norm_plain; CUDA tensors the kernels of csrc/batch_norm.cu
    (float32 parameters and statistics, a bf16 or float32 activation)."""
    if x.device.type == "cpu":
        return batch_norm_plain(x, weight, bias, running_mean, running_var,
                                momentum, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no batch norm for a {x.device.type} tensor")
    return _TrainBatchNorm.apply(x, weight, bias, running_mean, running_var,
                                 momentum, eps)
