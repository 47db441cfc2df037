"""8-bit greyscale and RGB PNG files with the standard library (zlib +
struct), so pseudo-label maps and images are read and written without
Pillow.

The writers emit one IHDR (bit depth 8; colour type 0 for greyscale, 2
for RGB), one IDAT with every scanline unfiltered (filter byte 0) and
IEND, which any PNG reader decodes. The readers take any chunk layout and
all five PNG row filters (None, Sub, Up, Average, Paeth; Pillow's encoder
chooses among them per row), non-interlaced 8-bit files only.
"""

from __future__ import annotations

import struct
import threading
import zlib

import numpy as np
from numpy.lib.stride_tricks import as_strided

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # greyscale, RGB, RGBA


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _write(path: str, image: np.ndarray, colour_type: int) -> None:
    H, W = image.shape[:2]
    rows = np.zeros((H, image[0].size + 1), np.uint8)  # column 0: filter 0
    rows[:, 1:] = image.reshape(H, -1)
    data = (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, colour_type,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def write_gray8(path: str, image: np.ndarray) -> None:
    """image: (H, W) uint8."""
    image = np.asarray(image)
    if image.ndim != 2 or image.dtype != np.uint8:
        raise ValueError(f"want an (H, W) uint8 map, got {image.shape} "
                         f"{image.dtype}")
    _write(path, image, 0)


def write_rgb8(path: str, image: np.ndarray) -> None:
    """image: (H, W, 3) uint8."""
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8:
        raise ValueError(f"want an (H, W, 3) uint8 image, got {image.shape} "
                         f"{image.dtype}")
    _write(path, image, 2)


def _predictor_table() -> np.ndarray:
    """(5 * 511 * 511,) int32: for filter f and the differences
    da = a - c, db = b - c (each in [-255, 255]), the filter's predictor
    minus c. Sub predicts a = c + da, Up b = c + db, Average
    (a + b) >> 1 = c + ((da + db) >> 1), Paeth the one of a, b, c nearest
    to p = a + b - c; None predicts 0, which the caller gets by not adding
    c back."""
    d = np.arange(-255, 256)
    da, db = np.meshgrid(d, d, indexing="ij")
    pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)  # |p - a|, ...
    paeth = np.where((pa <= pb) & (pa <= pc), da, np.where(pb <= pc, db, 0))
    return np.stack([np.zeros_like(da), da, db, (da + db) >> 1,
                     paeth]).astype(np.int32).reshape(-1)


_PREDICTOR = _predictor_table()
_DIFFS = 511  # values of a - c and of b - c
# One walk at a time: each of its numpy calls releases the GIL, and
# threads walking together trade it at every call, which measured slower
# than one thread alone (tools/png_timing.py).
_WALK_LOCK = threading.Lock()


def _diagonal_walk(filt: np.ndarray, ftype: np.ndarray, prev: np.ndarray,
                   bpp: int) -> np.ndarray:
    """(k, W * bpp) filtered scanlines of any filters, below the decoded
    row `prev` -> (k, W * bpp) uint8.

    Byte (y, x) depends on its left neighbour a = (y, x - bpp), the byte
    above b = (y - 1, x) and their corner c, so the pixels of one
    anti-diagonal (y + x fixed) are independent: the walk takes the
    k + W - 1 diagonals in order, each one vectorised over its rows. The
    rows are stored sheared, pixel (y, x) at S[x + y + 1, y] (row 0 is
    `prev`, and S[y, y] the zero left of row y), so a diagonal and its two
    predecessors are contiguous slices of S."""
    k, n = filt.shape
    W = n // bpp
    S = np.zeros((W + k + 1, k + 1, bpp), np.int32)
    s0, s1, s2 = S.strides
    rows = as_strided(S[1:], (k + 1, W, bpp), (s0 + s1, s0, s2))
    rows[0] = prev.reshape(W, bpp)
    rows[1:] = filt.reshape(k, W, bpp)
    # per row, full width, so that every step's arithmetic is flat
    ft = np.repeat(np.concatenate([[0], ftype]).astype(np.int32)[:, None],
                   bpp, 1)
    base = ft * _DIFFS * _DIFFS + 255 * _DIFFS + 255
    keep_c = (ft != 0).astype(np.int32) if (ft[1:] == 0).any() else None
    for t in range(1, k + W):
        lo, hi = max(1, t - W + 1), min(k, t) + 1
        a, b = S[t, lo:hi], S[t, lo - 1:hi - 1]
        c = S[t - 1, lo - 1:hi - 1]
        idx = a - c
        idx *= _DIFFS
        idx += b
        idx -= c
        idx += base[lo:hi]
        pred = _PREDICTOR.take(idx)
        # None rows predict 0, not c
        pred += c if keep_c is None else c * keep_c[lo:hi]
        cur = S[t + 1, lo:hi]
        cur += pred
        cur &= 0xFF
    return rows[1:].astype(np.uint8).reshape(k, n)


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + W * bpp) filtered scanlines -> (H, W * bpp) uint8.

    Rows above the first Average or Paeth row are decoded one vector step
    each (None a copy, Sub a cumulative sum mod 256 per channel, Up an add
    of the row above); from that row on, Average and Paeth make each byte
    wait for its left neighbour, and the rest goes through
    _diagonal_walk."""
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    filt = raw[:, 1:]
    H, n = filt.shape
    out = np.empty((H, n), np.uint8)
    walk = np.flatnonzero(ftype >= 3)
    y0 = int(walk[0]) if walk.size else H
    prev = np.zeros(n, np.uint8)
    for y in range(y0):  # uint8 arithmetic wraps mod 256
        if ftype[y] == 0:
            out[y] = filt[y]
        elif ftype[y] == 1:
            np.cumsum(filt[y].reshape(-1, bpp), axis=0, dtype=np.uint8,
                      out=out[y].reshape(-1, bpp))
        else:
            np.add(filt[y], prev, out=out[y])
        prev = out[y]
    if y0 < H:
        with _WALK_LOCK:
            out[y0:] = _diagonal_walk(filt[y0:], ftype[y0:], prev, bpp)
    return out


def _read(path: str):
    """(H, W, channels) uint8 pixels and the colour type of an 8-bit,
    non-interlaced greyscale, RGB or RGBA PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or header[2] != 8 or header[3] not in _CHANNELS \
            or header[4:] != (0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit greyscale, RGB or RGBA "
                         f"non-interlaced PNG (IHDR {header})")
    W, H = header[:2]
    ch = _CHANNELS[header[3]]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)),
                        np.uint8).reshape(H, W * ch + 1)
    return _unfilter(raw, ch).reshape(H, W, ch), header[3]


def read_gray8(path: str) -> np.ndarray:
    """(H, W) uint8 map of an 8-bit greyscale PNG."""
    pixels, colour_type = _read(path)
    if colour_type != 0:
        raise ValueError(f"{path}: not a greyscale PNG (colour type "
                         f"{colour_type})")
    return pixels[:, :, 0]


def read_rgb8(path: str) -> np.ndarray:
    """(H, W, 3) uint8 image, as Pillow's Image.open(path).convert("RGB")
    gives it: greyscale replicated to three channels, alpha dropped."""
    pixels, colour_type = _read(path)
    if colour_type == 0:
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])
