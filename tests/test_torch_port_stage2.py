"""The port's stage-2 path (losses/standard.cross_entropy, the
active_predignore criterion of engine/train.py, data/datasets.
RegionDatasetPlbl, utils/png.py's readers) against the JAX package and
Pillow, on the CPU.

- cross_entropy with ignore pixels and a temperature: value rtol 1e-6,
  logits gradient atol 1e-6.
- Three active_predignore steps on the small model twin against the JAX
  package's make_train_step, to test_three_train_steps_match_jax's
  tolerances: step-0 loss 1e-5 relative, the parameters and the BN
  statistics after 3 steps 1e-4 relative (L2 over all leaves). Dropout is
  off on both sides. The labels are blobby maps, as pseudo-labels are.
  The LR is 5e-5, half that test's, for the reason it gives: Adam's first
  steps move each element by about lr * sign(g), and an element whose
  gradient lies within float32 noise of 0 steps either way. Under CE more
  elements do: at LR 1e-4 and T 1 a float64 run of the port lies 3.7e-4
  from the float32 port and 2.4e-4 from the float32 JAX run, so no
  float32 run meets 1e-4 there; at 5e-5 the two agree to 5e-5.
- RegionDatasetPlbl items equal the JAX package's on PNG files written to
  a temp dir (the port's images channel-first).
- read_rgb8 / read_gray8 bitwise against Pillow's decoding: on files
  Pillow wrote (its encoder picks None, Sub, Up or Paeth per row; it
  never tries Average) and on files written here with every row filter,
  Average included; on one-row and one-column files and filter orders
  that start the anti-diagonal walk below rows decoded row by row or put
  None rows inside it; and from more threads than cores at once.
"""

import os
import struct
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch
from PIL import Image

from mulactseg_tpu.config import Config as JaxConfig
from mulactseg_tpu.data.datasets import RegionDatasetPlbl as JaxPlblDataset
from mulactseg_tpu.engine.state import create_train_state
from mulactseg_tpu.engine.train import make_train_step as jax_make_train_step
from mulactseg_tpu.losses.standard import cross_entropy as jax_ce
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.data.datasets import RegionDatasetPlbl
from mulactseg_tpu_torch.data.synthetic import _blobby_labels
from mulactseg_tpu_torch.engine.train import make_train_step
from mulactseg_tpu_torch.losses.standard import cross_entropy
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.models.layers import Dropout
from mulactseg_tpu_torch.utils.png import (
    read_gray8,
    read_rgb8,
    write_gray8,
    write_rgb8,
)
from tests.test_torch_port_model import NC, jax_variables, twin_pair
from tests.test_torch_port_train import _global_rel

torch.set_num_threads(1)


@pytest.mark.parametrize("temp", [1.0, 0.1])
def test_cross_entropy_matches_jax(temp):
    rng = np.random.RandomState(0)
    B, C, H, W = 2, 6, 9, 7
    logits = (rng.randn(B, C, H, W) * 3).astype(np.float32)
    labels = rng.randint(0, C, (B, H, W)).astype(np.int32)
    labels[rng.rand(B, H, W) < 0.2] = 255
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss = cross_entropy(lt, torch.from_numpy(labels), temp=temp)
    loss.backward()

    def f(lg):
        return jax_ce(lg, jnp.asarray(labels), temp=temp)

    jl, jg = jax.value_and_grad(f)(jnp.asarray(logits.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(),
                               np.asarray(jg).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-6)
    # every pixel ignored: 0, as the JAX package's max(count, 1)
    none = cross_entropy(lt, torch.full((B, H, W), 255), temp=temp)
    assert float(none.detach()) == 0.0


def test_three_active_predignore_steps_match_jax(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, **kw: x)
    B, H, steps = 4, 33, 3
    common = dict(num_classes=NC - 1, nseg=12, crop_size=(H, H),
                  train_lr=5e-5, cls_lr_scale=10.0, weight_decay=5e-4,
                  power=0.9, min_lr=1e-6, finetune_itrs=steps,
                  method="active_predignore", ce_temp=0.1,
                  dtype="float32", loader="synthetic")
    cfg, jcfg = Config(**common), JaxConfig(**common)
    port, ref = twin_pair(separable=True)
    v = jax_variables(ref, 7)
    convert.load_variables(port, v)
    for m in port.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    step = make_train_step(port, cfg, device="cpu")
    state = create_train_state(ref, jcfg, jax.random.PRNGKey(0),
                               (B, H, H, 3))
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"],
                          opt_state=state.tx.init(v["params"]))
    jstep = jax_make_train_step(ref, jcfg, donate=False)

    rng = np.random.RandomState(8)
    for it in range(steps):
        # per-image scale and offset keep each BN's batch variance well
        # above float32 cancellation (see test_torch_port_train.make_batch)
        images = (rng.randn(B, H, H, 3)
                  * np.linspace(0.5, 2.0, B)[:, None, None, None]
                  + np.linspace(-2.0, 2.0, B)[:, None, None, None]
                  ).astype(np.float32)
        labels = np.stack([_blobby_labels(rng, H, H, NC)
                           for _ in range(B)]).astype(np.int32)
        labels[rng.rand(B, H, H) < 0.1] = 255
        aux = step({"images": images.transpose(0, 3, 1, 2).copy(),
                    "labels": labels, "fnames": [["a", "b", "c"]] * B})
        state, jaux = jstep(state, {"images": jnp.asarray(images),
                                    "labels": jnp.asarray(labels)},
                            jax.random.PRNGKey(it))
        if it == 0:
            assert float(aux["train_loss"]) > 0
            np.testing.assert_allclose(float(aux["train_loss"]),
                                       float(jaux["train_loss"]), rtol=1e-5)
    assert step.step == steps
    got = convert.state_dict_to_variables(port.state_dict())
    err = _global_rel(got["params"], state.params)
    assert err < 1e-4, err
    assert _global_rel(v["params"], state.params) > 20 * err
    assert _global_rel(got["batch_stats"], state.batch_stats) < 1e-4


def test_region_dataset_plbl_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    (tmp_path / "plbl").mkdir()
    im_idx = []
    for i, (h, w) in enumerate([(20, 30), (17, 13)]):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        plbl = rng.randint(0, NC, (h, w)).astype(np.uint8)
        plbl[rng.rand(h, w) < 0.1] = 255
        ip = str(tmp_path / f"img_{i}.png")
        (write_rgb8 if i else lambda p, a: Image.fromarray(a).save(p))(ip,
                                                                     img)
        write_gray8(str(tmp_path / "plbl" / f"lbl_{i}.png"), plbl)
        im_idx.append([ip, f"gt/lbl_{i}.png", f"spx_{i}.pkl"])
    plbl_dir = str(tmp_path / "plbl")
    ds = RegionDatasetPlbl(Config(), im_idx, plbl_dir)
    jds = JaxPlblDataset(JaxConfig(), im_idx, plbl_dir)
    assert len(ds) == len(jds) == 2 and ds.suppix == jds.suppix == {}
    for i in range(2):
        got, want = ds[i], jds[i]
        assert got.keys() == want.keys()
        assert got["fnames"] == want["fnames"]
        assert got["labels"].dtype == want["labels"].dtype == np.int32
        np.testing.assert_array_equal(got["labels"], want["labels"])
        assert got["images"].dtype == np.float32
        np.testing.assert_array_equal(got["images"].transpose(1, 2, 0),
                                      want["images"])


def _test_image(H, W, C, seed):
    """Rows meant for each filter: noise (None), horizontal ramps (Sub),
    repeats (Up), the average of left and up (Average) and ramps over the
    row above (Paeth)."""
    rng = np.random.RandomState(seed)
    img = np.zeros((H, W, C), np.int64)
    xx = np.arange(W)[:, None]
    for y in range(H):
        k = y % 5
        if k == 0:
            img[y] = rng.randint(0, 256, (W, C))
        elif k == 1:
            img[y] = (xx * 5 + np.arange(C) * 7 + y) % 256
        elif k == 2:
            img[y] = img[y - 1]
        elif k == 3:
            img[y, 0] = rng.randint(0, 256, C)
            for x in range(1, W):
                img[y, x] = (img[y, x - 1] + img[y - 1, x]) // 2
        else:
            img[y] = (img[y - 1] + xx * 3) % 256
    return img.astype(np.uint8)


def _filters_used(path):
    data = open(path, "rb").read()
    pos, idat = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IHDR":
            W, H, _, ct = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    ch = {0: 1, 2: 3}[ct]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(raw.reshape(H, W * ch + 1)[:, 0].tolist())


def _write_filtered(path, img, filters=(0, 1, 2, 3, 4)):
    """An 8-bit PNG whose row y uses filter filters[y % len(filters)], in
    two IDAT chunks."""
    H, W = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(H, W * ch).astype(np.int64)
    rows = []
    for y in range(H):
        a = np.concatenate([np.zeros(ch, np.int64), x[y, :-ch]])
        b = x[y - 1] if y else np.zeros_like(x[y])
        c = np.concatenate([np.zeros(ch, np.int64), b[:-ch]])
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        f = filters[y % len(filters)]
        pred = [0, a, b, (a + b) // 2, paeth][f]
        rows.append(bytes([f]) + ((x[y] - pred) % 256).astype(
            np.uint8).tobytes())
    body = zlib.compress(b"".join(rows))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8,
                                             0 if ch == 1 else 2, 0, 0, 0))
                + chunk(b"IDAT", body[:len(body) // 2])
                + chunk(b"IDAT", body[len(body) // 2:])
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 1])
def test_png_readers_match_pillow_on_every_filter(tmp_path, channels):
    img = _test_image(41, 29, channels, seed=channels)
    if channels == 1:
        img = img[..., 0]
    read = read_rgb8 if channels == 3 else read_gray8
    pil_path, own_path = str(tmp_path / "pil.png"), str(tmp_path / "own.png")
    Image.fromarray(img).save(pil_path)
    _write_filtered(own_path, img)
    assert _filters_used(pil_path) == {0, 1, 2, 4}
    assert _filters_used(own_path) == {0, 1, 2, 3, 4}
    for path in (pil_path, own_path):
        pil = Image.open(path)
        want = np.asarray(pil.convert("RGB") if channels == 3 else pil)
        got = read(path)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, img)
    # the writers' files decode to the same pixels in Pillow
    out = str(tmp_path / "w.png")
    (write_rgb8 if channels == 3 else write_gray8)(out, img)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), img)
    assert _filters_used(out) == {0}
    if channels == 1:  # a greyscale file read as RGB, as convert("RGB")
        np.testing.assert_array_equal(
            read_rgb8(pil_path), np.asarray(Image.open(pil_path).convert(
                "RGB")))
        rgb = str(tmp_path / "w_rgb.png")
        write_rgb8(rgb, np.stack([img] * 3, -1))
        with pytest.raises(ValueError, match="greyscale"):
            read_gray8(rgb)


@pytest.mark.parametrize("shape,filters", [
    ((1, 1, 3), (4,)),
    ((1, 6, 3), (3,)),
    ((7, 1), (4, 3, 1)),
    ((6, 5), (1, 2, 0, 2)),  # no Average or Paeth row: decoded row by row
    ((9, 4, 3), (2, 1, 4, 0, 0, 3)),  # the walk starts below row-wise rows
    ((5, 7, 3), (4, 0, 4, 3)),  # None rows inside the walk
])
def test_png_readers_on_edge_shapes_and_filter_orders(tmp_path, shape,
                                                      filters):
    img = np.random.RandomState(len(shape) * 7 + shape[0]).randint(
        0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "e.png")
    _write_filtered(path, img, filters)
    assert _filters_used(path) == set(filters[:shape[0]])
    read = read_rgb8 if img.ndim == 3 else read_gray8
    np.testing.assert_array_equal(read(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_png_readers_from_many_threads(tmp_path):
    """More threads than cores read filtered files at once, with a short
    switch interval; every read must give the image."""
    img = _test_image(23, 17, 3, seed=9)
    paths = []
    for i, filters in enumerate([(4,), (3, 4), (1, 4, 2), (0, 1, 2)]):
        paths.append(str(tmp_path / f"t{i}.png"))
        _write_filtered(paths[-1], img, filters)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(2 * (os.cpu_count() or 1) + 2) as pool:
            futures = [pool.submit(read_rgb8, p) for p in paths * 16]
            got = [f.result(timeout=60) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    for g in got:
        np.testing.assert_array_equal(g, img)
