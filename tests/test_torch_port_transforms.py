"""The port's transforms (mulactseg_tpu_torch/data/transforms.py) and its
host resampler (csrc/resample.cpp through native.py) against the JAX
package's and Pillow.

- native.resize_bilinear_u8 is byte for byte Pillow's bilinear resize
  (with box windows) and the JAX package's build of the same source
  (test_torch_port_resample.py holds it against a numpy statement of
  Pillow's filter).
- _pil_nearest_index is exact against Pillow's NEAREST and the JAX copy.
- Each recipe transform (and its 513 twin, and the validation
  transforms) at seeds 0-3, on images larger and smaller than the crop
  (so the pad path runs): the image before normalisation (emit_u8) is
  byte-equal to the JAX one (with the JAX package's native library
  built), after normalisation bitwise equal, transposed; labels exactly
  equal. The draws taken apart (draw, then apply) give the same items.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from mulactseg_tpu import native as jax_native
from mulactseg_tpu.config import Config as JaxConfig
from mulactseg_tpu.data import transforms as jax_tf
from mulactseg_tpu_torch import native
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.data import transforms as tf
from tests.test_torch_port_resample import _random_case

torch.set_num_threads(1)

@pytest.mark.parametrize("seed", range(4))
def test_resampler_matches_pillow_and_the_jax_build(seed):
    assert jax_native.lib() is not None, "the JAX package's native build"
    rng = np.random.RandomState(seed)
    for _ in range(25):
        img, size, box = _random_case(rng)
        got = native.resize_bilinear_u8(img, size, box=box)
        pil = np.asarray(Image.fromarray(img).resize(
            (size[1], size[0]), Image.BILINEAR, box=box))
        ctx = str((img.shape, size, box))
        np.testing.assert_array_equal(got, pil, err_msg=ctx)
        np.testing.assert_array_equal(
            got, jax_native.resize_bilinear_u8(img, size, box=box),
            err_msg=ctx)


def test_pil_nearest_index_exact():
    rng = np.random.RandomState(11)
    for _ in range(60):
        w0, nw = rng.randint(3, 400), rng.randint(3, 500)
        a = np.arange(w0, dtype=np.int32)[None, :].repeat(2, 0)
        pil = np.asarray(Image.fromarray(a, mode="I").resize(
            (nw, 2), Image.NEAREST))[0]
        got = tf._pil_nearest_index(w0, nw)
        np.testing.assert_array_equal(got, pil, err_msg=f"{w0}->{nw}")
        np.testing.assert_array_equal(got, jax_tf._pil_nearest_index(w0, nw))


def _cfgs(**kw):
    base = dict(crop_size=(24, 32), nseg=50, dtype="float32")
    base.update(kw)
    return Config(**base), JaxConfig(**base)


def _inputs(rng, hw, n_labels):
    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    labels = [rng.randint(0, 50, hw).astype(np.int32)]
    labels.append(rng.randint(0, 256, hw).astype(np.uint8))  # raw GT ids
    return img, labels[:n_labels]


TRAIN_NAMES = ("rescale_769_multi_notrg", "rescale_513_multi_notrg",
               "rescale_769_multi_ignore_notrg",
               "rescale_513_multi_ignore_notrg", "rescale_769_nospx",
               "rescale_513_notrg", "eval_spx")


def _compare(port, jax, img, labels, u8):
    got_img, got_l = port(img, labels)
    want_img, want_l = jax(img, labels)
    assert got_img.dtype == (np.uint8 if u8 else np.float32)
    assert want_img.dtype == got_img.dtype
    np.testing.assert_array_equal(got_img, want_img.transpose(2, 0, 1))
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    return got_img, got_l


@pytest.mark.parametrize("name", TRAIN_NAMES)
@pytest.mark.parametrize("u8", [True, False], ids=["bytes", "normalised"])
def test_recipe_transforms_match_jax(name, u8):
    assert jax_native.lib() is not None
    cfg, jcfg = _cfgs(ship_uint8=u8)
    n_labels = 2 if "ignore" in name else 1
    for seed in range(4):
        port = tf.get_train_transform(name, cfg, seed=seed)
        jax = jax_tf.get_train_transform(name, jcfg, seed=seed)
        if name == "eval_spx":  # the identity emits float32 in both
            port.emit_u8 = jax.emit_u8 = u8
        rng = np.random.RandomState(100 + seed)
        # larger than the crop at every scale, smaller at most, mixed
        for hw in ((70, 90), (11, 14), (30, 20)):
            for _ in range(3):  # the stream advances item by item
                img, labels = _inputs(rng, hw, n_labels)
                got_img, got_l = _compare(port, jax, img, labels, u8)
                if name != "eval_spx":
                    assert got_img.shape[1:] == cfg.crop_size


def test_scaled_crop_pads_each_label_with_its_value():
    cfg, _ = _cfgs()
    t = tf.get_train_transform("rescale_769_multi_ignore_notrg", cfg)
    rng = np.random.RandomState(0)
    img, labels = _inputs(rng, (8, 8), 2)
    s, y0, x0, flip = t.draw((8, 8))
    out, (gt, spx) = t(img, labels, (s, y0, x0, False))
    n = int(round(8 * s))
    assert n < 24 and (gt[n:] == 255).all() and (spx[:, n:] == cfg.nseg).all()
    u8 = tf.PairedTransform(scale_range=(0.5, 2.0), crop_size=(24, 32),
                            emit_u8=True)
    pad = u8(img, [], (s, y0, x0, False))[0]
    assert (pad[:, n:] == np.asarray([124, 116, 104])[:, None, None]).all()


@pytest.mark.parametrize("dataset", ["cityscapes", "gta5"])
def test_val_transform_matches_jax(dataset):
    cfg, jcfg = _cfgs(dataset=dataset,
                      num_classes=19 if dataset == "cityscapes" else 6)
    rng = np.random.RandomState(4)
    for hw in ((1024, 2048), (37, 53)):
        img, labels = _inputs(rng, hw, 2)
        got_img, got_l = _compare(tf.get_val_transform(cfg),
                                  jax_tf.get_val_transform(jcfg), img,
                                  labels, False)
        if dataset == "cityscapes":
            assert got_img.shape == (3, 1024, 2048)


@pytest.mark.parametrize("seed", range(4))
def test_draws_taken_apart_are_the_stream(seed):
    """draw() in one place and the transform applied in another give the
    items of one transform called in order (the loader's split)."""
    cfg, _ = _cfgs()
    a = tf.get_train_transform("rescale_769_multi_notrg", cfg, seed=seed)
    b = tf.get_train_transform("rescale_769_multi_notrg", cfg, seed=seed)
    rng = np.random.RandomState(seed)
    items = [_inputs(rng, hw, 1) for hw in ((40, 50), (12, 9), (33, 61))]
    params = [b.draw(img.shape[:2]) for img, _ in items]
    for (img, labels), p in zip(items, params):
        want_img, want_l = a(img, labels)
        got_img, got_l = b(img, labels, p)
        np.testing.assert_array_equal(got_img, want_img)
        np.testing.assert_array_equal(got_l[0], want_l[0])


def test_transforms_the_port_does_not_have_raise():
    with pytest.raises(KeyError, match="unknown transform"):
        tf.get_train_transform("rescale_1024", _cfgs()[0])
    with pytest.raises(NotImplementedError):
        tf.PairedTransform(scale_range=(0.5, 2.0))
