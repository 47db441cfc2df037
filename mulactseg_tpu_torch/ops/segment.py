"""Softmax-fused segment max over (B, C, HW) logits: the port of
mulactseg_tpu/ops/segment.py's segment_softmax_max_nchw (forward through
segment_pallas.scatter_softmax_max_nchw, backward through
scatter_softmax_bwd_nchw).

Forward (K3, csrc/segment.cu ssm_fwd): ((S, C) float32 max of
softmax(logits / T), (S, C) int32 first-argmax global pixel, P for absent
segments). Backward (K4, ssm_bwd): the sparse cotangent at the argmax
pixels pushed through the softmax. Tensors on the CPU take the plain
PyTorch versions below; CUDA tensors take the kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

from mulactseg_tpu_torch.ops import _build

MAX_CLASSES = 32


def _softmax(xc, temp):
    """Same op order as the TPU kernels (x * (1/T), e / z)."""
    u = xc.float() * (1.0 / temp)
    e = torch.exp(u - u.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)


def ssm_fwd_plain(xc, sid3, num_segments: int, temp: float):
    B, C, HW = xc.shape
    P, S = B * HW, num_segments
    rows = _softmax(xc, temp).permute(0, 2, 1).reshape(P, C)
    sid = sid3.reshape(P).long()
    valid = (sid >= 0) & (sid < S)
    rv, sv = rows[valid], sid[valid]
    idx = sv[:, None].expand(-1, C)
    mx = torch.zeros(S, C, device=xc.device).scatter_reduce_(
        0, idx, rv, "amax", include_self=False)
    pixel = torch.arange(P, device=xc.device)[valid]
    cand = torch.where(rv == mx[sv], pixel[:, None], P)
    pix = torch.full((S, C), P, device=xc.device, dtype=torch.long)
    pix.scatter_reduce_(0, idx, cand, "amin", include_self=True)
    return mx, pix.int()


def ssm_bwd_plain(xc, vals, pix, g, temp: float):
    """Dense form of the group-term backward (ops/segment.py:821-833)."""
    B, C, HW = xc.shape
    P = B * HW
    flat_pix = pix.reshape(-1).long()
    gf = g.reshape(-1).float()
    cls = torch.arange(C, device=xc.device).repeat(pix.shape[0])
    live = (flat_pix >= 0) & (flat_pix < P) & (gf != 0.0)
    q = flat_pix[live]
    dlm = torch.zeros(B, C, HW, device=xc.device)
    dlm.index_put_((q // HW, cls[live], q % HW),
                   gf[live] * vals.reshape(-1)[live])
    w = dlm.sum(dim=1, keepdim=True)
    return ((dlm - w * _softmax(xc, temp)) * (1.0 / temp)).to(xc.dtype)


def _check(xc, sid3, num_segments):
    if xc.dim() != 3 or sid3.shape != (xc.shape[0], 1, xc.shape[2]):
        raise ValueError(f"want logits (B, C, HW) and sid (B, 1, HW), got "
                         f"{tuple(xc.shape)} and {tuple(sid3.shape)}")
    if xc.dtype != torch.float32 or sid3.dtype != torch.int32:
        raise TypeError(f"want float32 logits and int32 sid, got "
                        f"{xc.dtype} and {sid3.dtype}")
    if not (xc.is_contiguous() and sid3.is_contiguous()):
        raise ValueError("logits and sid must be contiguous")
    if xc.shape[1] > MAX_CLASSES:
        raise ValueError(f"at most {MAX_CLASSES} classes, got {xc.shape[1]}")
    if sid3.device != xc.device:
        raise ValueError("logits and sid on different devices")
    if xc.shape[0] * xc.shape[2] >= 2 ** 31 - 1 or num_segments < 1:
        raise ValueError("pixel count must fit int32 and S >= 1")


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ssm_fwd(x, sid, keys, vals, pix, B, C, HW, S, 1/T, stream);
# ssm_bwd(x, vals, pix, g, dlm, dl, B, C, HW, S, 1/T, stream)
_ARGTYPES = {"ssm_fwd": [_VP] * 5 + [_I] * 4 + [_F, _VP],
             "ssm_bwd": [_VP] * 6 + [_I] * 4 + [_F, _VP]}


def _lib():
    return _build.load("segment", _ARGTYPES)


def ssm_fwd(xc, sid3, num_segments: int, temp: float):
    """K3. CPU tensors take the plain version; CUDA tensors the kernel."""
    if xc.device.type == "cpu":
        return ssm_fwd_plain(xc, sid3, num_segments, temp)
    _check(xc, sid3, num_segments)
    B, C, HW = xc.shape
    S = num_segments
    keys = torch.zeros(S, C, device=xc.device, dtype=torch.int64)
    vals = torch.empty(S, C, device=xc.device)
    pix = torch.empty(S, C, device=xc.device, dtype=torch.int32)
    code = _lib().ssm_fwd(xc.data_ptr(), sid3.data_ptr(), keys.data_ptr(),
                          vals.data_ptr(), pix.data_ptr(), B, C, HW, S,
                          1.0 / temp, _build.stream_ptr(xc.device))
    _build.check(code, "ssm_fwd")
    _build.LAUNCHES["ssm_fwd"] += 1
    return vals, pix


def ssm_bwd(xc, vals, pix, g, temp: float):
    """K4. g: (S, C) cotangent of the max values."""
    if xc.device.type == "cpu":
        return ssm_bwd_plain(xc, vals, pix, g, temp)
    B, C, HW = xc.shape
    S = vals.shape[0]
    if xc.dtype != torch.float32 or not xc.is_contiguous():
        raise TypeError("want contiguous float32 logits")
    for name, t, dt in (("vals", vals, torch.float32),
                        ("pix", pix, torch.int32), ("g", g, torch.float32)):
        if t.shape != (S, C) or t.dtype != dt or t.device != xc.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({S}, {C}) {dt} "
                             "tensor on the logits' device")
    dlm = torch.zeros_like(xc)
    dl = torch.empty_like(xc)
    code = _lib().ssm_bwd(xc.data_ptr(), vals.data_ptr(), pix.data_ptr(),
                          g.data_ptr(), dlm.data_ptr(), dl.data_ptr(), B, C,
                          HW, S, 1.0 / temp, _build.stream_ptr(xc.device))
    _build.check(code, "ssm_bwd")
    _build.LAUNCHES["ssm_bwd"] += 1
    return dl


class _SegmentSoftmaxMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xc, sid3, num_segments, temp):
        vals, pix = ssm_fwd(xc, sid3, num_segments, temp)
        ctx.save_for_backward(xc, vals, pix)
        ctx.temp = temp
        ctx.mark_non_differentiable(pix)
        return vals, pix

    @staticmethod
    def backward(ctx, gvals, _gpix):
        xc, vals, pix = ctx.saved_tensors
        dl = ssm_bwd(xc, vals, pix, gvals.float().contiguous(), ctx.temp)
        return dl, None, None, None


def segment_softmax_max_nchw(logits_cs, sid3, num_segments: int,
                             temp: float):
    """logits_cs (B, C, HW) float32, sid3 (B, 1, HW) int32 global segment
    ids (invalid marker == num_segments) -> ((S, C) max softmax prob,
    (S, C) int32 first-argmax pixel with P for absent segments);
    differentiable in the logits through the max values."""
    return _SegmentSoftmaxMax.apply(logits_cs, sid3, num_segments, temp)
