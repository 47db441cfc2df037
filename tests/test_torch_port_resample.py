"""The port's host C++ (native.py): the resampler of csrc/resample.cpp
against a numpy statement of Pillow's uint8 bilinear filter (fixed-point
separable coefficients at 22 bits, horizontal then vertical pass, box
windows), kept here for the tests only, its label gather against numpy's
indexing, and csrc/png_unfilter.cpp against the PNG specification's
filters written out byte by byte. Neither JAX nor Pillow is imported, so
the card's host runs these too (test_torch_port_cuda.py builds the
library there)."""

import numpy as np
import pytest
import torch

from mulactseg_tpu_torch import native

torch.set_num_threads(1)

PREC = 22  # Pillow's PRECISION_BITS for 8-bit images


def _coeffs(in_size, in0, in1, out_size):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc: per output
    position the first source index, the tap count and the fixed-point
    weights."""
    f0, f1 = np.float32(in0), np.float32(in1)
    scale = float(f1 - f0) / out_size
    fscale = max(scale, 1.0)
    support = 1.0 * fscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    count = np.zeros(out_size, np.int64)
    k = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = float(f0) + (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) / fscale)) / fscale
             for x in range(xmax)]
        ww = sum(w)
        if ww != 0.0:
            w = [v / ww for v in w]
        k[xx, :xmax] = [int(-0.5 + v * (1 << PREC)) if v < 0
                        else int(0.5 + v * (1 << PREC)) for v in w]
        first[xx], count[xx] = xmin, xmax
    return first, count, k


def _pass(img, first, k, axis):
    """One separable pass along `axis` of an (H, W, C) int64 array."""
    n = img.shape[axis]
    idx = np.minimum(first[:, None] + np.arange(k.shape[1]), n - 1)
    taps = np.take(img, idx, axis=axis)  # (..., out, ksize, ...)
    w = k.reshape((1,) * axis + k.shape + (1,) * (img.ndim - axis - 1))
    acc = (taps * w).sum(axis + 1) + (1 << (PREC - 1))
    return np.clip(acc >> PREC, 0, 255)


def numpy_resize_bilinear(img, size_hw, box=None):
    """Pillow's uint8 BILINEAR resize(+box) in numpy: horizontal pass over
    the rows the vertical pass reads, then the vertical pass; a pass runs
    only where Pillow's ImagingResampleInner runs it."""
    squeeze = img.ndim == 2
    x = (img[:, :, None] if squeeze else img).astype(np.int64)
    H, W = x.shape[:2]
    oh, ow = size_hw
    box = box or (0.0, 0.0, float(W), float(H))
    fx0, fy0, fx1, fy1 = (np.float32(v) for v in box)
    need_h = ow != W or fx0 != 0 or fx1 != ow
    need_v = oh != H or fy0 != 0 or fy1 != oh
    yfirst, ycount, ky = _coeffs(H, box[1], box[3], oh)
    if need_h:
        lo, hi = int(yfirst[0]), int(yfirst[-1] + ycount[-1])
        xfirst, _, kx = _coeffs(W, box[0], box[2], ow)
        x = _pass(x[lo:hi], xfirst, kx, 1)
        yfirst = yfirst - lo
    if need_v:
        x = _pass(x, yfirst, ky, 0)
    out = x.astype(np.uint8)
    return out[:, :, 0] if squeeze else out


def _random_case(rng):
    H, W = rng.randint(2, 120), rng.randint(2, 120)
    C = int(rng.choice([1, 3]))
    oh, ow = rng.randint(1, 130), rng.randint(1, 130)
    img = rng.randint(0, 256, (H, W, C) if C == 3 else (H, W)).astype(
        np.uint8)
    box = None
    if rng.rand() < 0.6:
        x0, y0 = rng.uniform(0, W - 1), rng.uniform(0, H - 1)
        box = (x0, y0, rng.uniform(x0 + 0.5, W), rng.uniform(y0 + 0.5, H))
    return img, (oh, ow), box


@pytest.mark.parametrize("seed", range(2))
def test_numpy_statement_of_the_filter_is_the_resampler(seed):
    rng = np.random.RandomState(10 + seed)
    for _ in range(15):
        img, size, box = _random_case(rng)
        np.testing.assert_array_equal(
            numpy_resize_bilinear(img, size, box),
            native.resize_bilinear_u8(img, size, box=box),
            err_msg=str((img.shape, size, box)))


def test_resampler_refuses_what_it_cannot_resize():
    with pytest.raises(ValueError, match="uint8"):
        native.resize_bilinear_u8(np.zeros((4, 4), np.int32), (2, 2))
    with pytest.raises(ValueError, match="refused"):
        native.resize_bilinear_u8(np.zeros((4, 4), np.uint8), (0, 2))


def test_gather2d_is_fancy_indexing():
    rng = np.random.RandomState(3)
    for dt in (np.uint8, np.int32):
        src = rng.randint(0, 200, (31, 47)).astype(dt)
        yi, xi = rng.randint(0, 31, 13), rng.randint(0, 47, 29)
        got = native.gather2d(src, yi, xi)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, src[yi[:, None], xi[None, :]])
    with pytest.raises(ValueError, match="inside"):
        native.gather2d(src, yi, np.asarray([0, 47]))


def _unfilter_reference(raw, bpp):
    """The five PNG row filters undone byte by byte, as the PNG
    specification states them."""
    H, n = raw.shape[0], raw.shape[1] - 1
    out = np.zeros((H, n), np.int64)
    for y in range(H):
        for x in range(n):
            a = out[y, x - bpp] if x >= bpp else 0
            b = out[y - 1, x] if y else 0
            c = out[y - 1, x - bpp] if y and x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = (0, a, b, (a + b) // 2, paeth)[raw[y, 0]]
            out[y, x] = (int(raw[y, x + 1]) + pred) % 256
    return out.astype(np.uint8)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_png_unfilter_is_the_specification(bpp):
    rng = np.random.RandomState(bpp)
    for H, W in ((1, 1), (5, 3), (9, 17)):
        raw = rng.randint(0, 256, (H, W * bpp + 1)).astype(np.uint8)
        raw[:, 0] = rng.randint(0, 5, H)
        raw[: min(H, 5), 0] = np.arange(min(H, 5))  # every filter
        np.testing.assert_array_equal(native.png_unfilter(raw, bpp),
                                      _unfilter_reference(raw, bpp))
    raw[-1, 0] = 5
    with pytest.raises(ValueError, match="unknown PNG row filter 5"):
        native.png_unfilter(raw, bpp)
    with pytest.raises(ValueError, match="bpp"):
        native.png_unfilter(raw, 0)
