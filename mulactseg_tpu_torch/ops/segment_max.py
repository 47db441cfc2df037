"""Segment max with first argmax over arbitrary (P, C) values: the port of
mulactseg_tpu/ops/segment.py's segment_max_grad (forward through
_seg_max_argmax_impl -> segment_pallas.segment_max_pallas, K5; backward
_smg_bwd, a gather-compare in plain XLA there and in plain torch here).

Forward (K5, csrc/segment_max.cu seg_max_fwd): ((S, C) float32 max, (S, C)
int32 argmax pixel), for C <= 128.
segment gives (0.0, P); among equal values the smallest pixel index wins
(the first in raster order, as the stable sort makes it in both JAX
paths). -0.0 counts as +0.0. NaN values are outside the contract.
Tensors on the CPU take the plain version below; CUDA tensors take the
kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from mulactseg_tpu_torch.ops import _build

MAX_CLASSES = 128  # K5 stages a warp's C keys in shared memory
# K5's span of pixels per block and its shared-table slots:
# csrc/segment_max.cu is built with them as SPAN and NSLOT (the fastest
# of those timed on an H100 that keep the table, PERF.md).
K5_SPAN = 1024
K5_SLOTS = 16
_build.DEFINES["segment_max"] = {"SPAN": K5_SPAN, "NSLOT": K5_SLOTS}
# K5's load paths (csrc/segment_max.cu Layout)
ANY, PLANES, ROWS = 0, 1, 2


def segment_max_plain(values, sid, num_segments: int):
    """values (P, C), sid (P,) with invalid pixels == num_segments ->
    ((S, C) float32 max, (S, C) int32 first argmax pixel, P if absent)."""
    P, C = values.shape
    S = num_segments
    # + 0.0 turns -0.0 into +0.0, as the kernel's key does
    v = values.float() + 0.0
    sid = sid.reshape(P).long()
    valid = (sid >= 0) & (sid < S)
    rv, sv = v[valid], sid[valid]
    idx = sv[:, None].expand(-1, C)
    mx = torch.zeros(S, C, device=v.device).scatter_reduce_(
        0, idx, rv, "amax", include_self=False)
    pixel = torch.arange(P, device=v.device)[valid]
    cand = torch.where(rv == mx[sv], pixel[:, None], P)
    pix = torch.full((S, C), P, device=v.device, dtype=torch.long)
    pix.scatter_reduce_(0, idx, cand, "amin", include_self=True)
    return mx, pix.int()


def _check(values, sid, num_segments):
    if values.dim() != 2 or sid.shape != (values.shape[0],):
        raise ValueError(f"want values (P, C) and sid (P,), got "
                         f"{tuple(values.shape)} and {tuple(sid.shape)}")
    if values.dtype != torch.float32 or sid.dtype != torch.int32:
        raise TypeError(f"want float32 values and int32 sid, got "
                        f"{values.dtype} and {sid.dtype}")
    if not sid.is_contiguous() or min(values.stride()) < 0:
        raise ValueError("sid must be contiguous and values strided "
                         "forward")
    if sid.device != values.device:
        raise ValueError("values and sid on different devices")
    if values.shape[0] >= 2 ** 31 - 1 or num_segments < 1 \
            or not 1 <= values.shape[1] <= MAX_CLASSES:
        raise ValueError(f"pixel count must fit int32, S >= 1 and 1 <= C <= "
                         f"{MAX_CLASSES}")


def layout(values) -> int:
    """K5's load path for (P, C) values: PLANES where a class's pixels are
    contiguous and 16-byte words (pixel stride 1, class stride and P
    multiples of 4, 16-byte aligned: the (C, P) planes of an NCHW tensor
    through .t()), ROWS for a contiguous (P, C) array with C a multiple of
    4, 16-byte aligned, else ANY (4-byte loads)."""
    P, C = values.shape
    ps, cs = values.stride()
    aligned = values.data_ptr() % 16 == 0
    if ps == 1 and cs % 4 == 0 and P % 4 == 0 and aligned:
        return PLANES
    if cs == 1 and ps == C and C % 4 == 0 and aligned:
        return ROWS
    return ANY


_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# seg_max_fwd(values, sid, keys, vals, pix, P, C, pixel stride,
#             class stride, S, layout, stream)
_ARGTYPES = {"seg_max_fwd": [_VP] * 5 + [_I, _I, _LL, _LL, _I, _I, _VP]}


def seg_max_fwd(values, sid, num_segments: int):
    """K5. values (P, C) float32 with any non-negative strides, so both a
    contiguous (P, C) array and the (C, P) planes of an NCHW tensor
    (`x.view(C, P).t()`) go in without a copy (`layout` picks the load
    path); sid (P,) int32. CPU tensors take the plain version; CUDA
    tensors the kernel. NaN values are outside the contract."""
    if values.device.type == "cpu":
        return segment_max_plain(values, sid, num_segments)
    _check(values, sid, num_segments)
    P, C = values.shape
    S = num_segments
    keys = torch.zeros(S, C, device=values.device, dtype=torch.int64)
    vals = torch.empty(S, C, device=values.device)
    pix = torch.empty(S, C, device=values.device, dtype=torch.int32)
    code = _build.load("segment_max", _ARGTYPES).seg_max_fwd(
        values.data_ptr(), sid.data_ptr(), keys.data_ptr(), vals.data_ptr(),
        pix.data_ptr(), P, C, values.stride(0), values.stride(1), S,
        layout(values), _build.stream_ptr(values.device))
    _build.check(code, "seg_max_fwd")
    _build.LAUNCHES["seg_max_fwd"] += 1
    return vals, pix


class _SegmentMaxGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, sid, num_segments):
        vals, pix = seg_max_fwd(values, sid, num_segments)
        ctx.save_for_backward(sid, pix)
        ctx.num_segments = num_segments
        ctx.mark_non_differentiable(pix)
        return vals, pix

    @staticmethod
    def backward(ctx, g, _gpix):
        """_smg_bwd: each pixel takes its segment's cotangent in the
        classes where it is the argmax."""
        sid, pix = ctx.saved_tensors
        S = ctx.num_segments
        P = sid.shape[0]
        sid = sid.long()
        sid_c = sid.clamp(0, S - 1)
        live = (pix[sid_c] == torch.arange(P, device=sid.device)[:, None]) \
            & (sid < S)[:, None]
        return torch.where(live, g.float()[sid_c], 0.0), None, None


def segment_max_grad(values, sid, num_segments: int):
    """Differentiable segment max: values (P, C), sid (P,) int32 with
    invalid pixels == num_segments -> ((S, C) max, (S, C) int32 argmax
    pixel); absent segments give (0.0, P). The gradient flows only to the
    argmax pixels."""
    return _SegmentMaxGrad.apply(values, sid, num_segments)
