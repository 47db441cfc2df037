"""The port's image readers without Pillow against Pillow: the JPEG decoder
(utils/jpeg.py over csrc/jpeg_decode.cpp) must give bitwise the pixels of
np.asarray(Image.open(p).convert("RGB")), the JAX package's open_image
(Pillow here decodes with libjpeg-turbo); palette PNGs (the VOC label
format) must read as Pillow's index maps.

- Pillow-written JPEGs at quality 75 and 95; 4:4:4, 4:2:2, 4:2:0 and
  4:1:1; greyscale; with and without restart intervals; at sizes that are
  not multiples of the MCU (375x500, 333x500, 17x31, 1x1) and on smooth and
  noise content (noise drives the IDCT's range limit).
- The port's writer (4:2:0, 4:2:2, 4:4:0, 4:4:4, the Annex K tables, which
  must be Pillow's): Pillow decodes its files as the port does; 4:4:0 is
  the h1v2 upsampling Pillow cannot write.
- Progressive, CMYK and RGB-coded files raise naming the marker; a
  truncated file raises.
- Palette PNGs (Pillow's, at the 1-, 2-, 4- and 8-bit depths it picks by
  palette size, and the port's writer) read as Pillow's index maps; the
  header sizes (data/datasets.image_size) match Pillow's.
"""

import io

import numpy as np
import pytest
from PIL import Image, features

from mulactseg_tpu.data import datasets as jd
from mulactseg_tpu_torch.data import datasets as pd
from mulactseg_tpu_torch.data.constants import voc_cmap
from mulactseg_tpu_torch.utils import jpeg
from mulactseg_tpu_torch.utils.png import read_gray, write_palette8

SIZES = ((375, 500), (333, 500), (17, 31), (1, 1))


def _content(H, W, seed, noise):
    rng = np.random.RandomState(seed)
    if noise:
        return rng.randint(0, 256, (H, W, 3), np.uint8)
    base = Image.fromarray((rng.rand(H // 8 + 2, W // 8 + 2, 3) * 255)
                           .astype(np.uint8)).resize((W, H), Image.BILINEAR)
    img = np.asarray(base, np.float64) + rng.randn(H, W, 3) * 6
    return np.clip(img, 0, 255).astype(np.uint8)


def _pillow(path):
    return np.asarray(Image.open(path).convert("RGB"))


def test_pillow_decodes_with_libjpeg_turbo():
    # the bitwise claims below are claims about libjpeg(-turbo)'s decoder
    assert features.check_feature("libjpeg_turbo")


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0",
                                         "4:1:1"])
def test_decoder_is_bitwise_pillow(tmp_path, size, subsampling):
    H, W = size
    path = str(tmp_path / "a.jpg")
    for i, (quality, restart, noise) in enumerate(
            [(q, r, n) for q in (75, 95) for r in (None, 2)
             for n in (False, True)]):
        kw = {"restart_marker_blocks": restart} if restart else {}
        Image.fromarray(_content(H, W, i, noise)).save(
            path, "JPEG", quality=quality, subsampling=subsampling, **kw)
        if restart and H * W > 64:
            assert b"\xff\xdd" in open(path, "rb").read()  # a DRI segment
        got = jpeg.read_rgb8(path)
        np.testing.assert_array_equal(got, _pillow(path),
                                      err_msg=f"q{quality} rst{restart}")
        assert jpeg.jpeg_size(path) == (H, W) == pd.image_size(path)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_greyscale_is_replicated_as_pillow_converts_it(tmp_path, size):
    path = str(tmp_path / "g.jpg")
    for quality in (75, 95):
        Image.fromarray(_content(*size, 1, False)[:, :, 0]).save(
            path, "JPEG", quality=quality)
        got = jpeg.read_rgb8(path)
        np.testing.assert_array_equal(got, _pillow(path))
        assert (got[..., 0] == got[..., 2]).all()


@pytest.mark.parametrize("sampling", [(2, 2), (2, 1), (1, 2), (1, 1)])
def test_writer_output_decodes_as_pillow_decodes_it(tmp_path, sampling):
    path = str(tmp_path / "w.jpg")
    for size in SIZES + ((500, 486), (16, 16)):
        img = _content(*size, 2, False)
        jpeg.write_jpeg(path, img, quality=75, sampling=sampling)
        want = _pillow(path)
        np.testing.assert_array_equal(jpeg.read_rgb8(path), want)
        layer = Image.open(path).layer
        assert [l[1:3] for l in layer] == [sampling, (1, 1), (1, 1)]
        # a lossy copy about as close as Pillow's own encoder makes
        Image.fromarray(img).save(path, "JPEG", quality=75, subsampling={
            (2, 2): "4:2:0", (2, 1): "4:2:2", (1, 1): "4:4:4"}.get(
                sampling, "4:4:4"))
        pillow_err = np.abs(_pillow(path).astype(int) - img).mean()
        assert np.abs(want.astype(int) - img).mean() <= 1.5 * pillow_err + 1


def test_writer_tables_are_pillows():
    """The Annex K tables: Pillow's quantisation at quality 50 (scale 100)
    and its default Huffman tables, read from a file it wrote."""
    buf = io.BytesIO()
    Image.fromarray(_content(16, 16, 0, True)).save(buf, "JPEG", quality=50)
    data = buf.getvalue()
    im = Image.open(io.BytesIO(data))
    for i, q in enumerate(jpeg.quant_tables(50)):
        assert list(q) == list(im.quantization[i])
    tables, pos = {}, 2
    while data[pos + 1] != 0xDA:
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] == 0xC4:
            p = pos + 4
            while p < pos + 2 + n:
                counts = tuple(data[p + 1:p + 17])
                tables[data[p]] = (counts, data[p + 17:p + 17 + sum(counts)])
                p += 17 + sum(counts)
        pos += 2 + n
    assert tables == {0x00: jpeg.HUFFMAN["dc0"], 0x01: jpeg.HUFFMAN["dc1"],
                      0x10: jpeg.HUFFMAN["ac0"], 0x11: jpeg.HUFFMAN["ac1"]}


@pytest.mark.parametrize("mode,match", [
    ("progressive", "SOF2 \\(progressive\\) frame \\(0xFFC2\\)"),
    ("cmyk", "0xFFC0\\) with 4 components"),
    ("rgb", "stored as RGB"),
])
def test_unsupported_modes_raise(tmp_path, mode, match):
    path = str(tmp_path / "u.jpg")
    img = Image.fromarray(_content(24, 40, 3, False))
    if mode == "progressive":
        img.save(path, "JPEG", progressive=True)
    elif mode == "cmyk":
        img.convert("CMYK").save(path, "JPEG")
    else:
        img.save(path, "JPEG", keep_rgb=True)
    for fn in (jpeg.read_rgb8, jpeg.jpeg_size, pd.open_image,
               pd.image_size):
        with pytest.raises(ValueError, match=match):
            fn(path)
    pd._decode_cache.clear()


def test_truncated_and_foreign_files_raise(tmp_path):
    path = str(tmp_path / "t.jpg")
    Image.fromarray(_content(64, 80, 4, True)).save(path, "JPEG")
    data = open(path, "rb").read()
    for cut in (len(data) // 2, 100):
        open(path, "wb").write(data[:cut])
        with pytest.raises(ValueError, match="t.jpg"):
            jpeg.read_rgb8(path)
    open(path, "wb").write(b"GIF89a" + bytes(40))
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        pd.open_image(path)


def _replace_segment(data, marker, body):
    """data with its first segment of this marker given a new body."""
    at = data.index(bytes([0xFF, marker]))
    n = int.from_bytes(data[at + 2:at + 4], "big")
    return (data[:at + 2] + (len(body) + 2).to_bytes(2, "big") + body
            + data[at + 2 + n:])


@pytest.mark.parametrize("case,match", [
    # three codes of length 1: over-subscribed
    ("dht_oversubscribed", "bad DQT or DHT table"),
    # two codes of length 1: the all-ones code, which libjpeg refuses
    ("dht_all_ones", "bad DQT or DHT table"),
    ("sof_short", "header is shorter"),
    ("sof_missing_component", "header is shorter"),
])
def test_malformed_headers_raise(tmp_path, case, match):
    path = str(tmp_path / "m.jpg")
    Image.fromarray(_content(24, 40, 5, True)).save(path, "JPEG")
    data = open(path, "rb").read()
    if case.startswith("dht"):
        n1 = 3 if case == "dht_oversubscribed" else 2
        body = bytes([0x00, n1] + [0] * 15 + list(range(n1)))
        data = _replace_segment(data, 0xC4, body)
    else:
        sof = data.index(b"\xff\xc0")
        body = data[sof + 4:sof + 4 + 6]  # precision, H, W, 3 components
        data = _replace_segment(
            data, 0xC0, body[:4] if case == "sof_short" else body + b"\x01")
    open(path, "wb").write(data)
    with pytest.raises(ValueError, match=f"m.jpg.*{match}"):
        jpeg.read_rgb8(path)
    with pytest.raises(OSError):  # libjpeg refuses the file too
        Image.open(path).convert("RGB")


@pytest.mark.parametrize("entries", [2, 4, 16, 21, 256])
def test_palette_pngs_read_as_pillows_index_maps(tmp_path, entries):
    rng = np.random.RandomState(entries)
    index = rng.randint(0, entries, (37, 53)).astype(np.uint8)
    palette = rng.randint(0, 256, (entries, 3)).astype(np.uint8)
    pil = Image.fromarray(index, "P")
    pil.putpalette(palette.reshape(-1).tolist())
    pil.save(tmp_path / "pil.png")
    write_palette8(str(tmp_path / "port.png"), index, palette)
    for name in ("pil.png", "port.png"):
        path = str(tmp_path / name)
        im = Image.open(path)
        assert im.mode == "P"
        np.testing.assert_array_equal(read_gray(path), np.asarray(im))
        np.testing.assert_array_equal(pd.open_label(path), jd.open_label(path))
    port = Image.open(tmp_path / "port.png")
    assert port.getpalette()[:3 * entries] == palette.reshape(-1).tolist()
    pd._decode_cache.clear()


def test_voc_palette_label_round_trip(tmp_path):
    lbl = np.zeros((20, 30), np.uint8)
    lbl[5:15, 8:20] = 15
    lbl[4, :] = 255
    path = str(tmp_path / "l.png")
    write_palette8(path, lbl, voc_cmap())
    np.testing.assert_array_equal(read_gray(path), lbl)
    rgb = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(rgb, voc_cmap()[lbl])
    with pytest.raises(ValueError, match="past the palette"):
        write_palette8(path, lbl, voc_cmap(21))
