"""8-bit greyscale, palette and RGB PNG files with zlib and struct, so
pseudo-label maps, label maps and images are read and written without
Pillow; 16-bit greyscale files (superpixel maps) are read too.

The writers emit one IHDR (bit depth 8; colour type 0 for greyscale, 3
for palette, with its PLTE chunk, 2 for RGB), one IDAT with every
scanline unfiltered (filter byte 0) and IEND, which any PNG reader
decodes. The readers take any chunks after IHDR and all five PNG row
filters (None, Sub, Up, Average, Paeth; Pillow's encoder chooses among
them per row), non-interlaced 8-bit greyscale, RGB and RGBA files, 1- to
8-bit palette files (read as the index map, as Pillow's
np.asarray(Image.open(path)) gives a "P" image: the PASCAL VOC label
format) and 16-bit greyscale files; another bit depth or colour type
raises. zlib inflates; the row filters are undone in one C++ pass
(csrc/png_unfilter.cpp through native.py), since Average and Paeth make
each byte wait for its left neighbour.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from mulactseg_tpu_torch import native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}  # greyscale, RGB, palette, RGBA


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _write(path: str, image: np.ndarray, colour_type: int,
           palette: bytes = b"") -> None:
    H, W = image.shape[:2]
    rows = np.zeros((H, image[0].size + 1), np.uint8)  # column 0: filter 0
    rows[:, 1:] = image.reshape(H, -1)
    data = (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, colour_type,
                                          0, 0, 0))
            + (_chunk(b"PLTE", palette) if palette else b"")
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


def write_palette8(path: str, index: np.ndarray,
                   palette: np.ndarray) -> None:
    """index: (H, W) uint8 map; palette: (n, 3) uint8 RGB entries, n <= 256,
    each index below n."""
    index, palette = np.asarray(index), np.asarray(palette)
    if index.ndim != 2 or index.dtype != np.uint8:
        raise ValueError(f"want an (H, W) uint8 map, got {index.shape} "
                         f"{index.dtype}")
    if palette.ndim != 2 or palette.shape[1] != 3 or palette.dtype != \
            np.uint8 or not 1 <= len(palette) <= 256:
        raise ValueError(f"want an (n, 3) uint8 palette, n <= 256, got "
                         f"{palette.shape} {palette.dtype}")
    if int(index.max(initial=0)) >= len(palette):
        raise ValueError(f"index {int(index.max())} past the palette's "
                         f"{len(palette)} entries")
    _write(path, index, 3, palette.tobytes())


def write_rgb8(path: str, image: np.ndarray) -> None:
    """image: (H, W, 3) uint8."""
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8:
        raise ValueError(f"want an (H, W, 3) uint8 image, got {image.shape} "
                         f"{image.dtype}")
    _write(path, image, 2)


def _header(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    if data[12:16] != b"IHDR":
        raise ValueError(f"{path}: the first chunk is not IHDR")
    return struct.unpack(">IIBBBBB", data[16:29])


def png_size(path: str):
    """(H, W) from the PNG header, without decoding."""
    with open(path, "rb") as f:
        W, H = _header(f.read(29), path)[:2]
    return H, W


def _read(path: str):
    """(H, W, channels) pixels, uint8 (or uint16 for a 16-bit greyscale
    file), and the colour type of a non-interlaced PNG."""
    with open(path, "rb") as f:
        data = f.read()
    header = _header(data, path)
    pos, idat = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    W, H, depth, colour_type = header[:4]
    if header[4:] != (0, 0, 0) or colour_type not in _CHANNELS or not (
            depth == 8 or (depth == 16 and colour_type == 0)
            or (depth in (1, 2, 4) and colour_type == 3)):
        raise ValueError(f"{path}: not an 8-bit greyscale, RGB or RGBA, a "
                         f"1- to 8-bit palette or a 16-bit greyscale "
                         f"non-interlaced PNG (IHDR {header})")
    ch = _CHANNELS[colour_type]
    # the filters work on bytes, bpp apart (1 below 8 bits a pixel)
    bpp = max(ch * depth // 8, 1)
    row = -(-W * ch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)),
                        np.uint8).reshape(H, row + 1)
    pixels = native.png_unfilter(raw, bpp)
    if depth == 16:  # big-endian samples
        pixels = pixels.view(">u2").astype(np.uint16)
    elif depth < 8:  # packed indices, the leftmost in the high bits
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        pixels = ((pixels[:, :, None] >> shifts) & ((1 << depth) - 1))
        pixels = pixels.reshape(H, -1)[:, :W]
    return pixels.reshape(H, W, ch), colour_type


def read_gray(path: str) -> np.ndarray:
    """(H, W) map of an 8-bit (uint8) or 16-bit (uint16) greyscale PNG, or
    the uint8 index map of an 8-bit palette PNG: the array
    np.asarray(Image.open(path)) gives for it with Pillow."""
    pixels, colour_type = _read(path)
    if colour_type not in (0, 3):
        raise ValueError(f"{path}: not a greyscale or palette PNG (colour "
                         f"type {colour_type})")
    return pixels[:, :, 0]


def read_gray8(path: str) -> np.ndarray:
    """(H, W) uint8 map of an 8-bit greyscale PNG."""
    pixels, colour_type = _read(path)
    if colour_type != 0 or pixels.dtype != np.uint8:
        raise ValueError(f"{path}: not an 8-bit greyscale PNG (colour "
                         f"type {colour_type})")
    return pixels[:, :, 0]


def read_rgb8(path: str) -> np.ndarray:
    """(H, W, 3) uint8 image, as Pillow's Image.open(path).convert("RGB")
    gives it: greyscale replicated to three channels, alpha dropped."""
    pixels, colour_type = _read(path)
    if pixels.dtype != np.uint8 or colour_type == 3:
        raise ValueError(f"{path}: a 16-bit or palette PNG is not read as "
                         "an RGB8 image")
    if colour_type == 0:
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])
