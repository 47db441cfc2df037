"""The host-side C++ of the loader: csrc/resample.cpp (the port's copy of
mulactseg_tpu/native/resample.cpp: Pillow's uint8 bilinear resample,
byte for byte, and the label gather of the random scaled crop) and
csrc/png_unfilter.cpp (the PNG row filters undone, for utils/png.py).

`lib()` compiles both with g++ on first use into
mulactseg_tpu_torch/_build/ (git-ignored) as host-<hash>.so, the hash
over the sources and the flags, and loads it with ctypes; each call
releases the GIL. The flags are the JAX package's: without
-ffp-contract=off the compiler fuses the coefficient arithmetic into FMAs
and about 1e-4 of the box-resampled pixels move by one step, so the bytes
stop matching Pillow's. The port has no Pillow to fall back to: a failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCES = (_PKG / "csrc" / "resample.cpp",
           _PKG / "csrc" / "png_unfilter.cpp")
BUILD_DIR = _PKG / "_build"
FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
         "-fPIC", "-shared")
_LOCK = threading.Lock()
_LIB = None


def build() -> Path:
    """Compiles the sources unless these sources and flags are built;
    returns the library's path. Raises if g++ fails."""
    src = b"".join(p.read_bytes() for p in SOURCES)
    tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"host-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *FLAGS, *map(str, SOURCES), "-o",
                           str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCES}:\n{proc.stderr}")
    os.replace(tmp, out)  # two processes building at once both succeed
    return out


def lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            L = ctypes.CDLL(str(build()))
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            L.resize_bilinear_u8.argtypes = [
                p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.c_double, ctypes.c_double, ctypes.c_double, p,
                ctypes.c_int, ctypes.c_int]
            L.resize_bilinear_u8.restype = ctypes.c_int
            for fn in (L.gather2d_i32, L.gather2d_u8):
                fn.argtypes = [p, i64, p, p, i64, i64, p]
                fn.restype = None
            L.png_unfilter.argtypes = [p, i64, i64, i64, p]
            L.png_unfilter.restype = ctypes.c_int
            _LIB = L
    return _LIB


def resize_bilinear_u8(img: np.ndarray, size_hw, box=None) -> np.ndarray:
    """Pillow's Image.resize((w, h), BILINEAR, box=box) of a uint8 (H, W)
    or (H, W, C) array; box (x0, y0, x1, y1) in source pixels, the whole
    image by default."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"want a uint8 (H, W[, C]) array, got {img.shape} "
                         f"{img.dtype}")
    squeeze = img.ndim == 2
    src = np.ascontiguousarray(img[:, :, None] if squeeze else img)
    H, W, C = src.shape
    oh, ow = int(size_hw[0]), int(size_hw[1])
    if box is None:
        box = (0.0, 0.0, float(W), float(H))
    out = np.empty((oh, ow, C), np.uint8)
    rc = lib().resize_bilinear_u8(src.ctypes.data, H, W, C, *map(float, box),
                                  out.ctypes.data, oh, ow)
    if rc != 0:
        raise ValueError(f"resize of {src.shape} to {(oh, ow)} refused")
    return out[:, :, 0] if squeeze else out


def gather2d(src: np.ndarray, yi: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """out[i, j] = src[yi[i], xi[j]] as int32, for uint8 or int32 maps."""
    src = np.ascontiguousarray(src)
    if src.dtype != np.uint8:
        src = np.ascontiguousarray(src, np.int32)
    yi = np.ascontiguousarray(yi, np.int64)
    xi = np.ascontiguousarray(xi, np.int64)
    for idx, n in ((yi, src.shape[0]), (xi, src.shape[1])):
        if src.ndim != 2 or idx.ndim != 1 or (
                idx.size and (idx.min() < 0 or idx.max() >= n)):
            raise ValueError("gather2d wants a 2-D map and 1-D indices "
                             "inside it")
    out = np.empty((yi.size, xi.size), np.int32)
    fn = lib().gather2d_u8 if src.dtype == np.uint8 else lib().gather2d_i32
    fn(src.ctypes.data, src.shape[1], yi.ctypes.data, xi.ctypes.data,
       yi.size, xi.size, out.ctypes.data)
    return out


def png_unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + n) filtered PNG scanlines, the filter type first ->
    (H, n) uint8 bytes; bpp: bytes per pixel."""
    raw = np.ascontiguousarray(raw, np.uint8)
    H, n = raw.shape[0], raw.shape[1] - 1
    if raw.ndim != 2 or not 1 <= bpp <= 8 or n % bpp:
        raise ValueError(f"want (H, 1 + W * bpp) scanlines with bpp in "
                         f"1..8, got {raw.shape} and bpp {bpp}")
    out = np.empty((H, n), np.uint8)
    if lib().png_unfilter(raw.ctypes.data, H, n, bpp, out.ctypes.data):
        raise ValueError(f"unknown PNG row filter "
                         f"{int(raw[:, 0].max())}")
    return out
