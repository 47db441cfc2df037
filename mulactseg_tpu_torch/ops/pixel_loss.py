"""Per-pixel partial-label CE/MC terms over (B, C, HW) logits: the port of
mulactseg_tpu/ops/pixel_loss_pallas.py's pixel_partial_ce_nchw.

Forward (K1, csrc/pixel_loss.cu pixel_ce_fwd) returns a (4,) float32
tensor (oh_nll_sum, oh_count, mh_nll_sum, mh_count); the backward (K2,
pixel_ce_bwd) recomputes the softmax from the inputs. Tensors on the CPU
take the plain PyTorch versions below; CUDA tensors take the kernels or
raise.
"""

from __future__ import annotations

import ctypes

import torch

from mulactseg_tpu_torch.ops import _build

EPS = 1e-8
MAX_CLASSES = 31  # candidate bitmasks are int32
_THREADS = 256  # K1: one block of partial sums per 256 pixels of an image


def _softmax_pos(xc, bits3, temp):
    """p (B,C,HW), t (B,C,HW), pos (B,HW), n (B,HW); same op order as
    pixel_loss_pallas._softmax_pos_cs (x / T, e / z)."""
    u = xc.float() / temp
    e = torch.exp(u - u.amax(dim=1, keepdim=True))
    p = e / e.sum(dim=1, keepdim=True)
    cls = torch.arange(xc.shape[1], device=xc.device, dtype=torch.int32)
    t = ((bits3.int() >> cls[None, :, None]) & 1).float()
    return p, t, (p * t).sum(dim=1), t.sum(dim=1)


def pixel_ce_fwd_plain(xc, bits3, temp: float):
    _, _, pos, n = _softmax_pos(xc, bits3, temp)
    nll = -torch.log(pos + EPS)
    oh, mh = n == 1, n > 1
    zero = torch.zeros((), device=xc.device)
    return torch.stack([torch.where(oh, nll, zero).sum(), oh.float().sum(),
                        torch.where(mh, nll, zero).sum(), mh.float().sum()])


def pixel_ce_bwd_plain(xc, bits3, g, temp: float):
    """g: (2,) float32 (cotangents of oh_nll_sum, mh_nll_sum)."""
    p, t, pos, n = _softmax_pos(xc, bits3, temp)
    zero = torch.zeros((), device=xc.device)
    scale = torch.where(n == 1, g[0], torch.where(n > 1, g[1], zero))
    coef = (scale / (temp * (pos + EPS)))[:, None]
    return (coef * (pos[:, None] * p - p * t)).to(xc.dtype)


def _check(xc, bits3):
    if xc.dim() != 3 or bits3.shape != (xc.shape[0], 1, xc.shape[2]):
        raise ValueError(f"want logits (B, C, HW) and bits (B, 1, HW), got "
                         f"{tuple(xc.shape)} and {tuple(bits3.shape)}")
    if xc.dtype != torch.float32 or bits3.dtype != torch.int32:
        raise TypeError(f"want float32 logits and int32 bits, got "
                        f"{xc.dtype} and {bits3.dtype}")
    if not (xc.is_contiguous() and bits3.is_contiguous()):
        raise ValueError("logits and bits must be contiguous")
    if xc.shape[1] > MAX_CLASSES:
        raise ValueError(f"at most {MAX_CLASSES} classes, got {xc.shape[1]}")
    if bits3.device != xc.device:
        raise ValueError("logits and bits on different devices")


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (x, bits, partials | g, out | dl, B, C, HW, temp, stream)
_ARGTYPES = {"pixel_ce_fwd": [_VP] * 4 + [_I] * 3 + [_F, _VP],
             "pixel_ce_bwd": [_VP] * 4 + [_I] * 3 + [_F, _VP]}


def _lib():
    return _build.load("pixel_loss", _ARGTYPES)


def pixel_ce_fwd(xc, bits3, temp: float):
    """K1. CPU tensors take the plain version; CUDA tensors the kernel."""
    if xc.device.type == "cpu":
        return pixel_ce_fwd_plain(xc, bits3, temp)
    _check(xc, bits3)
    B, C, HW = xc.shape
    partials = torch.empty(-(-HW // _THREADS) * B * 4, device=xc.device)
    out = torch.empty(4, device=xc.device)
    code = _lib().pixel_ce_fwd(xc.data_ptr(), bits3.data_ptr(),
                               partials.data_ptr(), out.data_ptr(), B, C, HW,
                               float(temp), _build.stream_ptr(xc.device))
    _build.check(code, "pixel_ce_fwd")
    _build.LAUNCHES["pixel_ce_fwd"] += 1
    return out


def pixel_ce_bwd(xc, bits3, g, temp: float):
    """K2. g: (2,) float32 device tensor (g_oh, g_mh)."""
    if xc.device.type == "cpu":
        return pixel_ce_bwd_plain(xc, bits3, g, temp)
    _check(xc, bits3)
    if g.shape != (2,) or g.dtype != torch.float32 or g.device != xc.device \
            or not g.is_contiguous():
        raise ValueError("g must be a contiguous (2,) float32 tensor on the "
                         "logits' device")
    B, C, HW = xc.shape
    dl = torch.empty_like(xc)
    code = _lib().pixel_ce_bwd(xc.data_ptr(), bits3.data_ptr(), g.data_ptr(),
                               dl.data_ptr(), B, C, HW, float(temp),
                               _build.stream_ptr(xc.device))
    _build.check(code, "pixel_ce_bwd")
    _build.LAUNCHES["pixel_ce_bwd"] += 1
    return dl


class _PixelPartialCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xc, bits3, temp):
        ctx.save_for_backward(xc, bits3)
        ctx.temp = temp
        return pixel_ce_fwd(xc, bits3, temp)

    @staticmethod
    def backward(ctx, gout):
        xc, bits3 = ctx.saved_tensors
        # counts carry no logits gradient; the two sums' cotangents stay on
        # the device
        g = gout[0::2].float().contiguous()
        return pixel_ce_bwd(xc, bits3, g, ctx.temp), None, None


def pixel_partial_ce_nchw(logits_cs, bits3, temp: float):
    """logits_cs (B, C, HW) float32, bits3 (B, 1, HW) int32 candidate
    bitmasks (0 = invalid pixel) -> (4,) float32 (oh_nll_sum, oh_count,
    mh_nll_sum, mh_count), differentiable in the logits."""
    return _PixelPartialCE.apply(logits_cs, bits3, temp)
