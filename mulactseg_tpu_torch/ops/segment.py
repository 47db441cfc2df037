"""Softmax-fused segment max: the port of mulactseg_tpu/ops/segment.py's
segment_softmax_max_nchw (over (B, C, HW) logits) and segment_softmax_max
(over pre-scaled (P, C) rows).

Both return ((S, C) float32 max of the softmax per (segment, class),
(S, C) int32 first-argmax global pixel, P for absent segments) and are
differentiable through the max values. Kernels, all in csrc/:

- K3 (segment.cu ssm_fwd): the NCHW forward at S + 1 <= 9216.
- K6 (prereduce.cu, prereduce_softmax_nchw) then K5 (segment_max.cu): the
  NCHW forward past that, with bf16-rounded values as the reference has.
- K4 (segment.cu ssm_bwd): the NCHW backward of both, a gather by the
  segment ids the forward saw.
- K7 (segment.cu ssm_rows_fwd): the row forward, K3's span walk over
  rows.
- K8 (prereduce.cu, prereduce_softmax_rows) then K5: the row forward with
  prereduce=True. The row backward is plain PyTorch, as it is plain XLA
  in the reference.

Tensors on the CPU take the plain PyTorch versions below; CUDA tensors
take the kernels or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mulactseg_tpu_torch.ops import _build
from mulactseg_tpu_torch.ops.pixel_loss import compiled_classes
from mulactseg_tpu_torch.ops.segment_max import seg_max_fwd, segment_max_plain

MAX_CLASSES = 32
# The reference runs K3 only while num_segments + 1 <= 9216
# (mulactseg_tpu/ops/segment.py:653-654) and the pre-reduced pipeline past
# it. The port keeps the same split, though the card's K3 has no such
# limit: the pre-reduced pipeline rounds the probabilities to bf16, so the
# guard decides which numbers the reference computes.
SCATTER_MAX_SEGMENTS = 9216
BLOCK = 4  # raster-block width of the pre-reduction (the reference's R)
# K3's span of pixels per block and its shared-table slots: csrc/segment.cu
# is built with them as SPAN and NSLOT; the card tests build ids around them.
K3_SPAN = 512
K3_SLOTS = 64
# The same for K7 over rows (ROWS_SPAN, a multiple of 256, and ROWS_NSLOT):
# the fastest of a grid timed on an H100 (PERF.md; tools/segment_timing.py
# --rows-span/--rows-slots).
K7_SPAN = 2048
K7_SLOTS = 16
_build.DEFINES["segment"] = {"ROWS_SPAN": K7_SPAN, "ROWS_NSLOT": K7_SLOTS,
                             "SPAN": K3_SPAN, "NSLOT": K3_SLOTS}


def _softmax(xc, temp):
    """Same op order as the TPU kernels (x * (1/T), e / z)."""
    u = xc.float() * (1.0 / temp)
    e = torch.exp(u - u.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)


def _round_bf16(x):
    """Round to nearest even bf16, kept in float32 (exact)."""
    return x.to(torch.bfloat16).float()


def ssm_fwd_plain(xc, sid3, num_segments: int, temp: float):
    B, C, HW = xc.shape
    rows = _softmax(xc, temp).permute(0, 2, 1).reshape(B * HW, C)
    return segment_max_plain(rows, sid3.reshape(-1), num_segments)


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


def prereduce_plain(xc, sid, num_segments: int, temp: float):
    """K6's function on (B, C, HW) logits (any strides) and (B, HW) ids,
    blocks of BLOCK pixels counted from each image's first pixel ->
    ((C, B*HW) float32 planes of bf16-rounded values, (C, B*nb) int32
    choices with nb = ceil(HW / BLOCK), (B*HW,) int32 retired ids)."""
    B, C, HW = xc.shape
    S = num_segments
    nb = -(-HW // BLOCK)
    pad = nb * BLOCK - HW
    dev = xc.device
    p = _softmax(xc, temp)
    pb = torch.nn.functional.pad(p, (0, pad)).reshape(B, C, nb, BLOCK)
    sb = torch.nn.functional.pad(sid.long(), (0, pad)).reshape(B, nb, BLOCK)
    inside = (torch.arange(nb * BLOCK, device=dev) < HW).reshape(nb, BLOCK)
    eq = (sb == sb[:, :, :1]) & inside
    vm = torch.where(eq[:, None], pb, -1.0)
    merged = vm.amax(dim=3)
    offs = torch.arange(BLOCK, device=dev)
    choice = torch.where(vm == merged[..., None], offs, BLOCK).amin(dim=3)
    v = torch.where(offs == 0, merged[..., None], pb)
    planes = _round_bf16(v.reshape(B, C, nb * BLOCK)[:, :, :HW])
    sid2 = torch.where((offs != 0) & eq, S, sb).reshape(B, nb * BLOCK)
    return (planes.permute(1, 0, 2).reshape(C, B * HW),
            choice.permute(1, 0, 2).reshape(C, B * nb).int(),
            sid2[:, :HW].reshape(B * HW).int())


def _check(x, sid, num_segments):
    """x (B, C, HW) logits with sid (B, 1, HW), or x (P, C) rows with sid
    (P,)."""
    want = (x.shape[0], 1, x.shape[2]) if x.dim() == 3 else x.shape[:1]
    if x.dim() not in (2, 3) or sid.shape != want:
        raise ValueError(f"want logits (B, C, HW) with sid (B, 1, HW) or rows "
                         f"(P, C) with sid (P,), got {tuple(x.shape)} and "
                         f"{tuple(sid.shape)}")
    if x.dtype != torch.float32 or sid.dtype != torch.int32:
        raise TypeError(f"want float32 logits and int32 sid, got "
                        f"{x.dtype} and {sid.dtype}")
    if not (x.is_contiguous() and sid.is_contiguous()):
        raise ValueError("logits and sid must be contiguous")
    if x.shape[1] > MAX_CLASSES:
        raise ValueError(f"at most {MAX_CLASSES} classes, got {x.shape[1]}")
    if sid.device != x.device:
        raise ValueError("logits and sid on different devices")
    if sid.numel() >= 2 ** 31 - 1 or math.prod(x.shape[1:]) >= 2 ** 31 \
            or num_segments < 1:
        raise ValueError("pixel count and one image's logits must fit "
                         "int32, and S >= 1")


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ssm_fwd(x, sid, keys, vals, pix, B, C, HW, S, 1/T, stream);
# ssm_bwd(x, sid, vals, pix, g, dl, B, C, HW, S, 1/T, stream);
# ssm_rows_fwd(x, sid, keys, vals, pix, P, C, S, nc, wide, stream)
_ARGTYPES = {"ssm_fwd": [_VP] * 5 + [_I] * 4 + [_F, _VP],
             "ssm_bwd": [_VP] * 6 + [_I] * 4 + [_F, _VP],
             "ssm_rows_fwd": [_VP] * 5 + [_I] * 5 + [_VP]}
# prereduce_nchw_fwd(x, sid, planes, choice, sid2, B, C, HW, S, 1/T, nc,
#                    vec, stream);
# prereduce_rows_fwd(x, sid, planes, choice, sid2, P, C, S, stream)
_PRE_ARGTYPES = {"prereduce_nchw_fwd": [_VP] * 5 + [_I] * 4
                 + [_F, _I, _I, _VP],
                 "prereduce_rows_fwd": [_VP] * 5 + [_I] * 3 + [_VP]}


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


def ssm_bwd(xc, sid3, vals, pix, g, temp: float):
    """K4: xc (B, C, HW) float32 logits, sid3 (B, 1, HW) int32 ids that
    the forward saw, (vals, pix) the forward's (S, C) outputs and g (S, C)
    the cotangent of the max values -> dl (B, C, HW). CPU tensors take the
    plain version; CUDA tensors the kernel.

    Precondition of the kernel: every live entry's pixel lies in its own
    segment, sid3[pix[s, c]] == s wherever pix[s, c] < B * HW. Both
    forward branches (ssm_fwd and _ssm_prereduced) guarantee it; the
    kernel gathers each pixel's coefficients from the row of its own
    segment, so an entry that broke it would be dropped. ssm_bwd_plain
    holds on any input."""
    if xc.device.type == "cpu":
        return ssm_bwd_plain(xc, vals, pix, g, temp)
    S = vals.shape[0]
    _check(xc, sid3, S)
    B, C, HW = xc.shape
    for name, t, dt in (("vals", vals, torch.float32),
                        ("pix", pix, torch.int32), ("g", g, torch.float32)):
        if t.shape != (S, C) or t.dtype != dt or t.device != xc.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({S}, {C}) {dt} "
                             "tensor on the logits' device")
    if pix.data_ptr() % 16:  # the kernel reads its rows 16 bytes at a time
        raise ValueError("pix must be 16-byte aligned")
    dl = torch.empty_like(xc)
    code = _lib().ssm_bwd(xc.data_ptr(), sid3.data_ptr(), vals.data_ptr(),
                          pix.data_ptr(), g.data_ptr(), dl.data_ptr(), B, C,
                          HW, S, 1.0 / temp, _build.stream_ptr(xc.device))
    _build.check(code, "ssm_bwd")
    _build.LAUNCHES["ssm_bwd"] += 1
    return dl


def _pre_outputs(x, B, C, HW):
    """Empty (planes, choices, retired ids) of a pre-reduction."""
    P = B * HW
    nb = -(-HW // BLOCK)
    return (torch.empty(C, P, device=x.device),
            torch.empty(C, B * nb, device=x.device, dtype=torch.int32),
            torch.empty(P, device=x.device, dtype=torch.int32))


def prereduce_instance(xc, sid3):
    """(nc, vec): K6's instance for (B, C, HW) logits. nc as K1's
    (pixel_loss.compiled_classes: 20 compiled, else 0 for C at run time);
    vec is True where a thread
    can read its raster block as one 16-byte word per class: HW % 4 == 0
    and logits and ids 16-byte aligned (the planes and retired ids, which
    the wrapper allocates, always are)."""
    HW = xc.shape[2]
    return compiled_classes(xc.shape[1]), HW % 4 == 0 \
        and xc.data_ptr() % 16 == 0 and sid3.data_ptr() % 16 == 0


def prereduce_softmax_nchw(xc, sid3, num_segments: int, temp: float):
    """K6: xc (B, C, HW) float32 logits, sid3 (B, 1, HW) int32 ->
    ((C, P) float32 planes, (C, B * ceil(HW/4)) int32 choices, (P,) int32
    retired ids), as prereduce_plain. CPU tensors take the plain version;
    CUDA tensors the kernel."""
    B, C, HW = xc.shape
    if xc.device.type == "cpu":
        return prereduce_plain(xc, sid3.reshape(B, HW), num_segments, temp)
    _check(xc, sid3, num_segments)
    planes, choice, sid2 = out = _pre_outputs(xc, B, C, HW)
    nc, vec = prereduce_instance(xc, sid3)
    code = _build.load("prereduce", _PRE_ARGTYPES).prereduce_nchw_fwd(
        xc.data_ptr(), sid3.data_ptr(), planes.data_ptr(), choice.data_ptr(),
        sid2.data_ptr(), B, C, HW, num_segments, 1.0 / temp, nc, int(vec),
        _build.stream_ptr(xc.device))
    _build.check(code, "prereduce_nchw")
    _build.LAUNCHES["prereduce_nchw"] += 1
    return out


def prereduce_softmax_rows(scaled, sid, num_segments: int):
    """K8: K6's function over (P, C) float32 rows already divided by T (no
    temperature), one run of blocks from row 0; sid (P,) int32."""
    P, C = scaled.shape
    if scaled.device.type == "cpu":
        return prereduce_plain(scaled.t()[None], sid[None], num_segments,
                               1.0)
    _check(scaled, sid, num_segments)
    planes, choice, sid2 = out = _pre_outputs(scaled, 1, C, P)
    code = _build.load("prereduce", _PRE_ARGTYPES).prereduce_rows_fwd(
        scaled.data_ptr(), sid.data_ptr(), planes.data_ptr(),
        choice.data_ptr(), sid2.data_ptr(), P, C, num_segments,
        _build.stream_ptr(scaled.device))
    _build.check(code, "prereduce_rows")
    _build.LAUNCHES["prereduce_rows"] += 1
    return out


def _pixel_of_row(row, choice, B, HW):
    """(S, C) winning pre-reduced row -> pixel: a block leader's row goes
    to its block's start plus the saved choice, any other row is its own
    pixel, an absent entry (row P) stays P (ops/segment.py:729-742)."""
    P = B * HW
    nb = -(-HW // BLOCK)
    r = row.long().clamp(max=P - 1)
    b, hw = r // HW, r % HW
    cls = torch.arange(row.shape[1], device=row.device)
    ch = choice[cls, b * nb + hw // BLOCK].long()
    pix = torch.where(hw % BLOCK == 0, r + ch, r)
    return torch.where(row < P, pix, P).int()


def _ssm_prereduced(xc, sid3, num_segments: int, temp: float):
    """The reference's sorted group term (ops/segment.py:670-742): K6, K5
    on the bf16-rounded rows under the retired ids, and the map back. K5
    takes the smallest row among equal maxima, which is what the stable
    sort and the run walk give there, so no sort is needed."""
    B, C, HW = xc.shape
    planes, choice, sid2 = prereduce_softmax_nchw(xc, sid3, num_segments,
                                                  temp)
    vals, row = seg_max_fwd(planes.t(), sid2, num_segments)
    return vals, _pixel_of_row(row, choice, B, HW)


class _SegmentSoftmaxMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xc, sid3, num_segments, temp, prereduce):
        fwd = _ssm_prereduced if prereduce else ssm_fwd
        vals, pix = fwd(xc, sid3, num_segments, temp)
        ctx.save_for_backward(xc, sid3, vals, pix)
        ctx.temp = temp
        ctx.mark_non_differentiable(pix)
        return vals, pix

    @staticmethod
    def backward(ctx, gvals, _gpix):
        """K4 in both branches; after the pre-reduction p_c is the
        bf16-rounded max, as in the reference (ops/segment.py:781-820)."""
        xc, sid3, vals, pix = ctx.saved_tensors
        dl = ssm_bwd(xc, sid3, vals, pix, gvals.float().contiguous(),
                     ctx.temp)
        return dl, None, None, None, None


def segment_softmax_max_nchw(logits_cs, sid3, num_segments: int,
                             temp: float):
    """logits_cs (B, C, HW) float32, sid3 (B, 1, HW) int32 global segment
    ids (invalid marker == num_segments) -> ((S, C) max softmax prob,
    (S, C) int32 first-argmax pixel with P for absent segments);
    differentiable in the logits through the max values.

    Follows the reference: K3 while num_segments + 1 <=
    SCATTER_MAX_SEGMENTS, else the pre-reduced term, whose values are
    rounded to bf16 and whose ties are broken after that rounding. The
    guard comes from the TPU's VMEM, but it changes the numbers the
    reference computes, so the port keeps it; whether the card should drop
    the rounding at large S is for the reference to decide. The dispatch
    keys on S alone: the reference's only caller, lossdecomp_fused, pads
    HW so that its kernel path always runs.
    """
    prereduce = num_segments + 1 > SCATTER_MAX_SEGMENTS
    return _SegmentSoftmaxMax.apply(logits_cs, sid3, num_segments, temp,
                                    prereduce)


def ssm_rows_fwd_plain(scaled, sid, num_segments: int):
    """K7's function: the softmax (float32, e / z) of the bf16-rounded rows,
    then the first-argmax segment max."""
    u = _round_bf16(scaled)
    e = torch.exp(u - u.amax(dim=1, keepdim=True))
    return segment_max_plain(e / e.sum(dim=1, keepdim=True), sid,
                             num_segments)


def rows_instance(scaled):
    """(nc, wide): K7's instance for (P, C) rows. nc as K1's
    (pixel_loss.compiled_classes: 20 compiled, else 0 for C at run time);
    wide is True where a warp can read its rows as 16-byte units: C % 4 ==
    0 and the rows 16-byte aligned."""
    C = scaled.shape[1]
    return compiled_classes(C), C % 4 == 0 and scaled.data_ptr() % 16 == 0


def ssm_rows_fwd(scaled, sid, num_segments: int):
    """K7: scaled (P, C) float32 rows (logits / T), sid (P,) int32. CPU
    tensors take the plain version; CUDA tensors the kernel."""
    if scaled.device.type == "cpu":
        return ssm_rows_fwd_plain(scaled, sid, num_segments)
    _check(scaled, sid, num_segments)
    lib = _lib()
    P, C = scaled.shape
    S = num_segments
    keys = torch.zeros(S, C, device=scaled.device, dtype=torch.int64)
    vals = torch.empty(S, C, device=scaled.device)
    pix = torch.empty(S, C, device=scaled.device, dtype=torch.int32)
    nc, wide = rows_instance(scaled)
    code = lib.ssm_rows_fwd(scaled.data_ptr(), sid.data_ptr(),
                            keys.data_ptr(), vals.data_ptr(), pix.data_ptr(),
                            P, C, S, nc, int(wide),
                            _build.stream_ptr(scaled.device))
    _build.check(code, "ssm_rows_fwd")
    _build.LAUNCHES["ssm_rows_fwd"] += 1
    return vals, pix


def ssm_rows_bwd(scaled, vals, pix, g):
    """_ssm_bwd (ops/segment.py:520-554): g * p_c at each live argmax
    (pixel, class), then dl = dl_elem - rowsum(dl_elem) * softmax of the
    unrounded rows. No 1/T: the rows are already scaled. Dead entries go
    to a spare row P, so nothing syncs."""
    P, C = scaled.shape
    flat_pix = pix.reshape(-1).long()
    gf = g.reshape(-1).float()
    cls = torch.arange(C, device=scaled.device).repeat(pix.shape[0])
    live = (flat_pix < P) & (gf != 0.0)
    dl_elem = torch.zeros(P + 1, C, device=scaled.device)
    dl_elem.index_put_((torch.where(live, flat_pix, P), cls),
                       torch.where(live, gf * vals.reshape(-1), 0.0),
                       accumulate=True)
    dl_elem = dl_elem[:P]
    w = dl_elem.sum(dim=1, keepdim=True)
    return (dl_elem - w * torch.softmax(scaled.float(), dim=1)).to(
        scaled.dtype)


class _SegmentSoftmaxMaxRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scaled, sid, num_segments, prereduce):
        if prereduce:
            planes, choice, sid2 = prereduce_softmax_rows(scaled, sid,
                                                          num_segments)
            vals, row = seg_max_fwd(planes.t(), sid2, num_segments)
            pix = _pixel_of_row(row, choice, 1, scaled.shape[0])
        else:
            vals, pix = ssm_rows_fwd(scaled, sid, num_segments)
        ctx.save_for_backward(scaled, vals, pix)
        ctx.mark_non_differentiable(pix)
        return vals, pix

    @staticmethod
    def backward(ctx, gvals, _gpix):
        scaled, vals, pix = ctx.saved_tensors
        return ssm_rows_bwd(scaled, vals, pix, gvals), None, None, None


def segment_softmax_max(scaled_logits, sid, num_segments: int,
                        prereduce: bool = False):
    """The row-major op (ops/segment.py:358-557): scaled_logits (P, C)
    float32 = logits / T, sid (P,) int32 with invalid pixels ==
    num_segments -> ((S, C) max softmax prob, (S, C) int32 first-argmax
    pixel, P for absent segments). prereduce=False runs K7 (the
    reference's default); True runs K8 then K5 (the reference under
    MULACTSEG_SSM_PREREDUCE=1). Both see bf16-rounded values: K7 rounds
    the logits, K8 the probabilities. Gradients flow to the rows through
    the float32 softmax at the argmax pixels."""
    return _SegmentSoftmaxMaxRows.apply(scaled_logits, sid, num_segments,
                                        bool(prereduce))
