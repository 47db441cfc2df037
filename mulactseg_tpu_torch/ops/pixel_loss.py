"""Per-pixel partial-label CE/MC terms: the port of
mulactseg_tpu/ops/pixel_loss_pallas.py's pixel_partial_ce_nchw over
(B, C, HW) logits and pixel_partial_ce over (N, C) rows.

Forward (K1, csrc/pixel_loss.cu pixel_ce_fwd; K9, pixel_ce_rows_fwd for
rows) returns a (4,) float32 tensor (oh_nll_sum, oh_count, mh_nll_sum,
mh_count), in one launch and bitwise reproducible; the backward (K2,
pixel_ce_bwd; K10, pixel_ce_rows_bwd) recomputes the softmax from the
inputs; K10 stages tiles of PIXELS_PER_BLOCK rows through shared memory.
Tensors on the CPU take the plain PyTorch versions below; CUDA tensors
take the kernels or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mulactseg_tpu_torch.ops import _build

EPS = 1e-8
MAX_CLASSES = 31  # candidate bitmasks are int32
# Pixels per block of every kernel here (4 per thread; K10: rows per tile):
# csrc/pixel_loss.cu is built with it as PIXELS, and K1's partials are
# sized by it.
PIXELS_PER_BLOCK = 512
_build.DEFINES["pixel_loss"] = {"PIXELS": PIXELS_PER_BLOCK}
# The class count compiled into the kernels (the stage-1 model's 19
# classes plus "undefined"); any other C takes the run-time instance.
COMPILED_CLASSES = 20


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


def _check(x, bits):
    """x (B, C, HW) logits with bits (B, 1, HW), or x (N, C) rows with
    bits (N,)."""
    want = (x.shape[0], 1, x.shape[2]) if x.dim() == 3 else x.shape[:1]
    if x.dim() not in (2, 3) or bits.shape != want:
        raise ValueError(f"want logits (B, C, HW) with bits (B, 1, HW) or "
                         f"rows (N, C) with bits (N,), got {tuple(x.shape)} "
                         f"and {tuple(bits.shape)}")
    if x.dtype != torch.float32 or bits.dtype != torch.int32:
        raise TypeError(f"want float32 logits and int32 bits, got "
                        f"{x.dtype} and {bits.dtype}")
    if not (x.is_contiguous() and bits.is_contiguous()):
        raise ValueError("logits and bits must be contiguous")
    if x.shape[1] > MAX_CLASSES:
        raise ValueError(f"at most {MAX_CLASSES} classes, got {x.shape[1]}")
    if bits.device != x.device:
        raise ValueError("logits and bits on different devices")
    # the kernels index one image's logits (or all rows) with int32
    if math.prod(x.shape[1:] if x.dim() == 3 else x.shape) >= 2 ** 31:
        raise ValueError("one image's logits must have fewer than 2**31 "
                         "elements")


def _check_g(g, x):
    if g.shape != (2,) or g.dtype != torch.float32 or g.device != x.device \
            or not g.is_contiguous():
        raise ValueError("g must be a contiguous (2,) float32 tensor on the "
                         "logits' device")


def num_blocks(B: int, HW: int) -> int:
    """Blocks of a (B, C, HW) launch: each covers PIXELS_PER_BLOCK pixels
    of one image, and K1 writes one partial (4 floats) per block."""
    return B * -(-HW // PIXELS_PER_BLOCK)


def compiled_classes(C: int) -> int:
    """The kernels' class-count instance for C classes: C where it is
    COMPILED_CLASSES, else 0 (C at run time)."""
    return C if C == COMPILED_CLASSES else 0


def instance(xc, bits3):
    """(nc, vec): the kernel instance for (B, C, HW) logits. vec is True
    where each thread can read its 4 pixels as one 16-byte copy per
    class: HW % 4 == 0 and logits and bits 16-byte aligned (dl, which the
    wrapper allocates, always is)."""
    HW = xc.shape[2]
    return compiled_classes(xc.shape[1]), HW % 4 == 0 \
        and xc.data_ptr() % 16 == 0 and bits3.data_ptr() % 16 == 0


def rows_instance(x, bits):
    """(nc, wide): K10's instance for (N, C) rows. wide is True where its
    tiles can move 16-byte units: C % 4 == 0 and rows and bits 16-byte
    aligned (dl, which the wrapper allocates, always is)."""
    C = x.shape[1]
    return compiled_classes(C), C % 4 == 0 and x.data_ptr() % 16 == 0 \
        and bits.data_ptr() % 16 == 0


_TICKETS: dict = {}


def _ticket(device):
    """K1's and K9's ticket counter on this device: zeroed once here, then
    reset by the last block of every launch. Launches on one device take
    it in stream order, so two forwards must not run at once on two
    streams of one device."""
    t = _TICKETS.get(device)
    if t is None:
        t = _TICKETS[device] = torch.zeros(1, dtype=torch.int32,
                                           device=device)
    return t


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# pixel_ce_fwd(x, bits, partials, ticket, out, B, C, HW, temp, nc, vec,
#              stream); pixel_ce_bwd(x, bits, g, dl, B, C, HW, temp, nc,
# vec, stream); the rows entry points take N, C in place of B, C, HW, K9
# no vec and K10 its wide in place of vec
_ARGTYPES = {"pixel_ce_fwd": [_VP] * 5 + [_I] * 3 + [_F] + [_I] * 2 + [_VP],
             "pixel_ce_bwd": [_VP] * 4 + [_I] * 3 + [_F] + [_I] * 2 + [_VP],
             "pixel_ce_rows_fwd": [_VP] * 5 + [_I] * 2 + [_F, _I, _VP],
             "pixel_ce_rows_bwd": [_VP] * 4 + [_I] * 2 + [_F, _I, _I, _VP]}


def _lib():
    return _build.load("pixel_loss", _ARGTYPES)


def pixel_ce_fwd(xc, bits3, temp: float):
    """K1. CPU tensors take the plain version; CUDA tensors the kernel."""
    if xc.device.type == "cpu":
        return pixel_ce_fwd_plain(xc, bits3, temp)
    _check(xc, bits3)
    lib = _lib()
    B, C, HW = xc.shape
    partials = torch.empty(num_blocks(B, HW) * 4, device=xc.device)
    out = torch.empty(4, device=xc.device)
    code = lib.pixel_ce_fwd(xc.data_ptr(), bits3.data_ptr(),
                            partials.data_ptr(), _ticket(xc.device).data_ptr(),
                            out.data_ptr(), B, C, HW, float(temp),
                            *instance(xc, bits3),
                            _build.stream_ptr(xc.device))
    _build.check(code, "pixel_ce_fwd")
    _build.LAUNCHES["pixel_ce_fwd"] += 1
    return out


def pixel_ce_bwd(xc, bits3, g, temp: float):
    """K2. g: (2,) float32 device tensor (g_oh, g_mh)."""
    if xc.device.type == "cpu":
        return pixel_ce_bwd_plain(xc, bits3, g, temp)
    _check(xc, bits3)
    _check_g(g, xc)
    lib = _lib()
    B, C, HW = xc.shape
    dl = torch.empty_like(xc)
    code = lib.pixel_ce_bwd(xc.data_ptr(), bits3.data_ptr(), g.data_ptr(),
                            dl.data_ptr(), B, C, HW, float(temp),
                            *instance(xc, bits3),
                            _build.stream_ptr(xc.device))
    _build.check(code, "pixel_ce_bwd")
    _build.LAUNCHES["pixel_ce_bwd"] += 1
    return dl


def pixel_ce_rows_fwd(x, bits, temp: float):
    """K9: x (N, C) float32 rows, bits (N,) int32. CPU tensors take the
    plain version (K1's, on the rows' (1, C, N) view); CUDA tensors the
    kernel."""
    if x.device.type == "cpu":
        return pixel_ce_fwd_plain(x.t()[None], bits[None, None], temp)
    _check(x, bits)
    lib = _lib()
    N, C = x.shape
    partials = torch.empty(num_blocks(1, N) * 4, device=x.device)
    out = torch.empty(4, device=x.device)
    code = lib.pixel_ce_rows_fwd(x.data_ptr(), bits.data_ptr(),
                                 partials.data_ptr(),
                                 _ticket(x.device).data_ptr(), out.data_ptr(),
                                 N, C, float(temp),
                                 compiled_classes(C),
                                 _build.stream_ptr(x.device))
    _build.check(code, "pixel_ce_rows_fwd")
    _build.LAUNCHES["pixel_ce_rows_fwd"] += 1
    return out


def pixel_ce_rows_bwd(x, bits, g, temp: float):
    """K10. g: (2,) float32 device tensor (g_oh, g_mh)."""
    if x.device.type == "cpu":
        return pixel_ce_bwd_plain(x.t()[None], bits[None, None], g,
                                  temp)[0].t()
    _check(x, bits)
    _check_g(g, x)
    lib = _lib()
    N, C = x.shape
    dl = torch.empty_like(x)
    nc, wide = rows_instance(x, bits)
    code = lib.pixel_ce_rows_bwd(x.data_ptr(), bits.data_ptr(), g.data_ptr(),
                                 dl.data_ptr(), N, C, float(temp), nc,
                                 int(wide), _build.stream_ptr(x.device))
    _build.check(code, "pixel_ce_rows_bwd")
    _build.LAUNCHES["pixel_ce_rows_bwd"] += 1
    return dl


class _PixelPartialCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits, temp, rows):
        ctx.save_for_backward(x, bits)
        ctx.temp, ctx.rows = temp, rows
        return (pixel_ce_rows_fwd if rows else pixel_ce_fwd)(x, bits, temp)

    @staticmethod
    def backward(ctx, gout):
        x, bits = ctx.saved_tensors
        # counts carry no logits gradient; the two sums' cotangents stay on
        # the device
        g = gout[0::2].float().contiguous()
        bwd = pixel_ce_rows_bwd if ctx.rows else pixel_ce_bwd
        return bwd(x, bits, g, ctx.temp), None, None, None


def pixel_partial_ce_nchw(logits_cs, bits3, temp: float):
    """logits_cs (B, C, HW) float32, bits3 (B, 1, HW) int32 candidate
    bitmasks (0 = invalid pixel) -> (4,) float32 (oh_nll_sum, oh_count,
    mh_nll_sum, mh_count), differentiable in the logits."""
    return _PixelPartialCE.apply(logits_cs, bits3, temp, False)


def pixel_partial_ce(logits2d, bits, temp: float):
    """The row-major op (pixel_loss_pallas.py:163-195): logits2d (N, C)
    float32, bits (N,) int32 candidate bitmasks (0 = invalid pixel) ->
    (4,) float32 (oh_nll_sum, oh_count, mh_nll_sum, mh_count),
    differentiable in the logits."""
    return _PixelPartialCE.apply(logits2d, bits, temp, True)
