"""JPEG files without Pillow: the reader of the PASCAL VOC images
(JPEGImages/*.jpg) and a small baseline writer for generated trees.

read_rgb8 gives the pixels Pillow's Image.open(path).convert("RGB") gives
(Pillow decodes with libjpeg-turbo's defaults): the header is read here,
the entropy-coded data is decoded by csrc/jpeg_decode.cpp (g++, through
native.py) with libjpeg's integer IDCT, fancy chroma upsampling and
fixed-point YCbCr -> RGB tables. It reads baseline (SOF0) and extended
sequential Huffman (SOF1) files with 8-bit samples and one (greyscale,
replicated to three channels) or three (YCbCr) components, with or
without restart intervals. Every other mode raises ValueError naming the
file and the marker: progressive (SOF2), lossless (SOF3), hierarchical
and arithmetic-coded frames, 12-bit samples, four components (CMYK,
YCCK), and three components stored as RGB (an Adobe APP14 marker with
transform 0, or component ids R, G, B without JFIF).

write_jpeg writes baseline files (4:2:0 by default) with the standard
tables of the
JPEG standard's Annex K (quantisation scaled by quality as libjpeg
scales it, Huffman tables K.3-K.6); any JPEG reader decodes them. Its
encoding is not meant to equal another encoder's.
"""

from __future__ import annotations

import struct

import numpy as np

from mulactseg_tpu_torch import native

_SOI = b"\xff\xd8"
# frame markers the reader takes
_SEQUENTIAL = {0xC0: "SOF0 (baseline)", 0xC1: "SOF1 (extended sequential)"}
# every other start-of-frame marker, refused
_REFUSED = {0xC2: "SOF2 (progressive)", 0xC3: "SOF3 (lossless)",
            0xC5: "SOF5 (differential sequential)",
            0xC6: "SOF6 (differential progressive)",
            0xC7: "SOF7 (differential lossless)",
            0xC9: "SOF9 (arithmetic sequential)",
            0xCA: "SOF10 (arithmetic progressive)",
            0xCB: "SOF11 (arithmetic lossless)",
            0xCD: "SOF13 (arithmetic differential sequential)",
            0xCE: "SOF14 (arithmetic differential progressive)",
            0xCF: "SOF15 (arithmetic differential lossless)"}
_DECODE_ERRORS = {1: "the data ends early", 2: "bad marker",
                  3: "bad DQT or DHT table", 4: "bad frame header",
                  5: "bad scan header or a table it names is missing",
                  6: "bad Huffman code", 7: "missing or out-of-order RSTn "
                  "marker", 8: "no frame before the scan"}


def _segments(f, path):
    """Yields (marker, body) of each segment up to the first scan's."""
    if f.read(2) != _SOI:
        raise ValueError(f"{path}: not a JPEG file (no SOI marker)")
    while True:
        b = f.read(1)
        if b != b"\xff":
            raise ValueError(f"{path}: no marker where a segment starts")
        while b == b"\xff":  # fill bytes before the marker code
            b = f.read(1)
        head = f.read(2)
        if not b or len(head) < 2:
            raise ValueError(f"{path}: the file ends before a frame header")
        marker, (n,) = b[0], struct.unpack(">H", head)
        body = f.read(n - 2)
        if n < 2 or len(body) < n - 2:
            raise ValueError(f"{path}: truncated segment 0xFF{marker:02X}")
        yield marker, body
        if marker == 0xDA:
            return


def header(path: str):
    """(H, W, components) from the frame header, after checking that the
    reader takes the file (module docstring); raises ValueError naming the
    marker otherwise."""
    jfif, adobe = False, None
    with open(path, "rb") as f:
        for marker, body in _segments(f, path):
            if marker == 0xE0 and body[:5] == b"JFIF\x00":
                jfif = True
            elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
                adobe = body[11]
            elif marker in _REFUSED:
                raise ValueError(f"{path}: {_REFUSED[marker]} frame "
                                 f"(0xFF{marker:02X}): the port reads "
                                 "baseline and extended sequential Huffman "
                                 "JPEGs only")
            elif marker in _SEQUENTIAL:
                what = f"{path}: {_SEQUENTIAL[marker]} frame (0xFF{marker:02X})"
                if len(body) < 6 or len(body) < 6 + 3 * body[5]:
                    raise ValueError(f"{what}: the header is shorter than "
                                     "its component count needs")
                precision, H, W, nc = struct.unpack(">BHHB", body[:6])
                if precision != 8:
                    raise ValueError(f"{what} with {precision}-bit samples: "
                                     "the port reads 8-bit JPEGs only")
                if nc not in (1, 3):
                    raise ValueError(f"{what} with {nc} components (CMYK or "
                                     "YCCK at 4): the port reads greyscale "
                                     "and YCbCr JPEGs only")
                ids = tuple(body[6 + 3 * i] for i in range(nc))
                if nc == 3 and not jfif and (
                        adobe == 0 or (adobe is None and ids == (82, 71, 66))):
                    raise ValueError(f"{what}: three components stored as "
                                     "RGB (APP14 Adobe transform 0, or ids "
                                     "R, G, B): the port reads YCbCr JPEGs "
                                     "only")
                if H == 0 or W == 0:
                    raise ValueError(f"{what}: zero height or width (a DNL "
                                     "marker is not read)")
                return H, W, nc
            elif marker == 0xDA:
                raise ValueError(f"{path}: a scan (0xFFDA) before any frame "
                                 "header")
    raise AssertionError("unreachable")


def jpeg_size(path: str):
    """(H, W) from the frame header, without decoding."""
    H, W, _ = header(path)
    return H, W


def read_rgb8(path: str) -> np.ndarray:
    """(H, W, 3) uint8 pixels, as Pillow's
    Image.open(path).convert("RGB") gives them."""
    H, W, _ = header(path)
    with open(path, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8)
    out = np.empty((H, W, 3), np.uint8)
    rc = native.lib().jpeg_decode(data.ctypes.data, data.size, H, W,
                                  out.ctypes.data)
    if rc:
        raise ValueError(f"{path}: cannot decode the JPEG data: "
                         f"{_DECODE_ERRORS.get(rc, rc)}")
    return out


# --- the writer ----------------------------------------------------------

# Annex K.1: luminance and chrominance quantisation, natural order
_QUANT = (
    np.asarray([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60,
                55, 14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87,
                80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64,
                81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72,
                92, 95, 98, 112, 100, 103, 99]),
    np.asarray([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99,
                99, 24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99,
                99, 99] + [99] * 32))
# zigzag position -> natural position
ZIGZAG = np.asarray([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50,
    43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63])
_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
# Annex K.3-K.6: (code counts by length 1..16, values) for DC luminance,
# DC chrominance, AC luminance and AC chrominance
HUFFMAN = {
    "dc0": ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
            bytes(range(12))),
    "dc1": ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
            bytes(range(12))),
    "ac0": ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D),
            _AC_LUMA_VALS),
    "ac1": ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
            _AC_CHROMA_VALS),
}


def _codes(counts, values):
    """symbol -> (code, length) of a canonical Huffman table (arrays
    indexed by symbol)."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for n_len, count in enumerate(counts, start=1):
        for _ in range(count):
            code[values[k]], length[values[k]] = c, n_len
            c += 1
            k += 1
        c <<= 1
    return code, length


def quant_tables(quality: int):
    """libjpeg's jpeg_quality_scaling of the Annex K tables, baseline
    (entries in 1..255), natural order."""
    if not 1 <= quality <= 100:
        raise ValueError(f"quality must be in 1..100, got {quality}")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [np.clip((q * scale + 50) // 100, 1, 255) for q in _QUANT]


def _dct_matrix():
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    d = np.sqrt(2 / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
    d[0] /= np.sqrt(2)
    return d


def _blocks(plane):
    """(h, w) plane, both multiples of 8 -> (h/8, w/8, 64) quantisable
    blocks, level-shifted, in natural order."""
    h, w = plane.shape
    b = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    d = _dct_matrix()
    return (d @ (b - 128.0) @ d.T).reshape(h // 8, w // 8, 64)


def _magnitude(v):
    """(size, the size low bits) of JPEG's signed value coding."""
    a = np.abs(v)
    size = np.zeros(v.shape, np.int64)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    bits = np.where(v >= 0, v, v + (1 << size) - 1)
    return size, bits


def _entropy(seq, comp, tables):
    """The entropy-coded bytes (stuffed) of blocks seq (N, 64) in zigzag
    order, scan order; comp (N,) their component (0 luma, whose tables
    are 0; 1 and 2 chroma, tables 1)."""
    N = seq.shape[0]
    # DC differences along each component's blocks
    diff = np.zeros(N, np.int64)
    for c in range(3):
        idx = np.flatnonzero(comp == c)
        dc = seq[idx, 0]
        diff[idx] = dc - np.concatenate([[0], dc[:-1]])
    (dcc0, dcl0), (dcc1, dcl1), (acc0, acl0), (acc1, acl1) = tables
    size, bits = _magnitude(diff)
    luma = comp == 0
    hc = np.where(luma, dcc0[size], dcc1[size])
    hl = np.where(luma, dcl0[size], dcl1[size])
    items = [(np.arange(N), np.zeros(N, np.int64), (hc << size) | bits,
              hl + size)]
    # AC: each nonzero coefficient, after its run of zeros
    blk, k = np.nonzero(seq[:, 1:])
    k = k + 1
    same = np.concatenate([[False], blk[1:] == blk[:-1]])
    run = k - np.where(same, np.roll(k, 1), 0) - 1
    size, bits = _magnitude(seq[blk, k])
    sym = ((run % 16) << 4) | size
    lum = comp[blk] == 0
    hc = np.where(lum, acc0[sym], acc1[sym])
    hl = np.where(lum, acl0[sym], acl1[sym])
    items.append((blk, 2 * k + 1, (hc << size) | bits, hl + size))
    zrl = np.repeat(np.arange(blk.size), run // 16)  # 16 zeros each
    zl = comp[blk[zrl]] == 0
    items.append((blk[zrl], 2 * k[zrl],
                  np.where(zl, acc0[0xF0], acc1[0xF0]),
                  np.where(zl, acl0[0xF0], acl1[0xF0])))
    last = np.zeros(N, np.int64)
    np.maximum.at(last, blk, k)
    eob = np.flatnonzero(last < 63)
    el = comp[eob] == 0
    items.append((eob, np.full(eob.size, 200), np.where(el, acc0[0], acc1[0]),
                  np.where(el, acl0[0], acl1[0])))
    b, key, code, length = (np.concatenate(a) for a in zip(*items))
    order = np.lexsort((key, b))
    code, length = code[order], length[order]
    # one bit array, MSB first, padded with 1 bits to a byte
    start = np.concatenate([[0], np.cumsum(length)[:-1]])
    total = int(length.sum())
    stream = np.ones(-(-total // 8) * 8, np.uint8)
    for j in range(int(length.max(initial=0))):
        m = length > j
        stream[start[m] + j] = (code[m] >> (length[m] - 1 - j)) & 1
    out = np.packbits(stream)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def write_jpeg(path: str, image: np.ndarray, quality: int = 75,
               sampling=(2, 2)) -> None:
    """image: (H, W, 3) uint8 RGB, written as a baseline JFIF file (module
    docstring). sampling: the luma's (horizontal, vertical) sampling
    factors against the chroma's 1, 1: (2, 2) is 4:2:0, (2, 1) 4:2:2,
    (1, 2) 4:4:0 and (1, 1) 4:4:4."""
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8:
        raise ValueError(f"want an (H, W, 3) uint8 image, got {image.shape} "
                         f"{image.dtype}")
    H, W = image.shape[:2]
    if not (0 < H < 65536 and 0 < W < 65536):
        raise ValueError(f"a baseline JPEG holds at most 65535x65535, got "
                         f"{H}x{W}")
    fh, fv = sampling
    if fh not in (1, 2) or fv not in (1, 2):
        raise ValueError(f"sampling factors must be 1 or 2, got {sampling}")
    rgb = image.astype(np.float64)
    R, G, B = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    ycc = [0.299 * R + 0.587 * G + 0.114 * B,
           -0.168736 * R - 0.331264 * G + 0.5 * B + 128,
           0.5 * R - 0.418688 * G - 0.081312 * B + 128]
    # pad to whole MCUs by repeating the last row and column
    Hp, Wp = -(-H // (8 * fv)) * 8 * fv, -(-W // (8 * fh)) * 8 * fh
    ycc = [np.pad(np.clip(np.round(p), 0, 255), ((0, Hp - H), (0, Wp - W)),
                  mode="edge") for p in ycc]
    chroma = [p.reshape(Hp // fv, fv, Wp // fh, fh).mean(axis=(1, 3))
              for p in ycc[1:]]
    qt = quant_tables(quality)
    zz = []
    for plane, q in ((ycc[0], qt[0]), (chroma[0], qt[1]), (chroma[1], qt[1])):
        coef = np.round(_blocks(plane) / q).astype(np.int64)
        zz.append(coef[..., ZIGZAG])
    My, Mx = Hp // (8 * fv), Wp // (8 * fh)
    y = zz[0].reshape(My, fv, Mx, fh, 64).transpose(0, 2, 1, 3, 4)
    seq = np.concatenate([y.reshape(My * Mx, fv * fh, 64),
                          zz[1].reshape(My * Mx, 1, 64),
                          zz[2].reshape(My * Mx, 1, 64)], axis=1)
    comp = np.tile([0] * (fv * fh) + [1, 2], My * Mx)
    tables = [_codes(*HUFFMAN[k]) for k in ("dc0", "dc1", "ac0", "ac1")]
    data = _entropy(seq.reshape(-1, 64), comp, tables)
    dht = b"".join(bytes([cls]) + bytes(HUFFMAN[k][0]) + HUFFMAN[k][1]
                   for cls, k in ((0x00, "dc0"), (0x01, "dc1"),
                                  (0x10, "ac0"), (0x11, "ac1")))
    out = (_SOI
           + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
           + _segment(0xDB, b"".join(bytes([i]) + bytes(
               q[ZIGZAG].astype(np.uint8)) for i, q in enumerate(qt)))
           + _segment(0xC0, struct.pack(">BHHB", 8, H, W, 3)
                      + bytes([1, fh << 4 | fv, 0, 2, 0x11, 1, 3, 0x11, 1]))
           + _segment(0xC4, dht)
           + _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
           + data + b"\xff\xd9")
    with open(path, "wb") as f:
        f.write(out)
