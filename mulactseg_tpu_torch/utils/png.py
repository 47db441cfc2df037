"""8-bit greyscale PNG files with the standard library (zlib + struct), so
the pseudo-label maps are written without Pillow.

`write_gray8` writes one IHDR (bit depth 8, colour type 0), one IDAT with
every scanline unfiltered (filter byte 0) and IEND, which any PNG reader
decodes. `read_gray8` reads such files back: it takes any chunk layout
but only the "None" row filter, and raises on anything else.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_gray8(path: str, image: np.ndarray) -> None:
    """image: (H, W) uint8."""
    image = np.asarray(image)
    if image.ndim != 2 or image.dtype != np.uint8:
        raise ValueError(f"want an (H, W) uint8 map, got {image.shape} "
                         f"{image.dtype}")
    H, W = image.shape
    rows = np.zeros((H, W + 1), np.uint8)  # column 0: filter type 0
    rows[:, 1:] = image
    data = (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def read_gray8(path: str) -> np.ndarray:
    """(H, W) uint8 map of an 8-bit greyscale, non-interlaced PNG whose rows
    carry filter type 0 (as write_gray8 makes them)."""
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
    if header is None or header[2:] != (8, 0, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit greyscale, non-interlaced "
                         f"PNG (IHDR {header})")
    W, H = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(H, W + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows use a PNG filter other than None")
    return rows[:, 1:].copy()
