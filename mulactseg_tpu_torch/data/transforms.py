"""Paired image + label-list transforms: the port's copy of
mulactseg_tpu/data/transforms.py (normalize :104, _pil_nearest_index :69,
PairedTransform :140-290, get_train_transform :293, get_val_transform
:321), without Pillow.

The image is resampled by csrc/resample.cpp (native.py), Pillow's uint8
bilinear filter byte for byte, the labels by the nearest grid of
Pillow's full resize. The random draws come from one RandomState(seed)
in the JAX package's order, s, y0, x0, flip, and `draw` takes them
apart from the work: a loader can draw each item's parameters in item
order in one process and apply them in another, and the stream stays
the one a single JAX worker sees.

Images come out channel-first (3, H, W), float32 through the same
256-entry table as the JAX package (bitwise its values), or uint8 with
emit_u8. The JAX package emits bf16 images when cfg.dtype is bfloat16;
the port keeps float32, and autocast rounds them at the first
convolution to the same values.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from mulactseg_tpu_torch import native
from mulactseg_tpu_torch.data.constants import IMAGENET_MEAN, IMAGENET_STD

_NORM_LUT = ((np.arange(256, dtype=np.float32)[:, None] / 255.0
              - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def normalize(img_u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 image -> normalised float32 (3, H, W)."""
    if img_u8.dtype != np.uint8 or img_u8.ndim != 3 or \
            img_u8.shape[-1] != 3:
        raise ValueError(f"want an (H, W, 3) uint8 image, got "
                         f"{img_u8.shape} {img_u8.dtype}")
    out = np.empty((3,) + img_u8.shape[:2], np.float32)
    for c in range(3):
        out[c] = _NORM_LUT[img_u8[..., c], c]
    return out


def _pil_nearest_index(n_src: int, n_out: int) -> np.ndarray:
    """Source index per output position of Pillow's NEAREST full resize:
    its C loop accumulates the sampling centre (x = a1 * 0.5; x += a1)
    and truncates, so ties follow the accumulated rounding, replicated
    here addition by addition."""
    a1 = n_src / n_out
    xs = np.empty(n_out)
    x = a1 * 0.5
    for k in range(n_out):
        xs[k] = x
        x += a1
    return np.minimum(xs.astype(np.int64), n_src - 1)


def resize_image(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a uint8 image (the identity at its own size, as
    Pillow's resample is)."""
    if img.shape[:2] == tuple(size_hw):
        return img
    return native.resize_bilinear_u8(img, size_hw)


def resize_label(lbl: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest resize of a label map, Pillow's grid."""
    if lbl.shape[:2] == tuple(size_hw):
        return lbl
    return native.gather2d(lbl, _pil_nearest_index(lbl.shape[0], size_hw[0]),
                           _pil_nearest_index(lbl.shape[1], size_hw[1]))


class PairedTransform:
    """transform(image (H, W, 3) uint8, labels [(H, W) int, ...]) ->
    (image (3, h, w) float32 or uint8, [(h, w) int32, ...]).

    The named transforms use three forms: a random scale in scale_range
    with a random crop_size crop, padded where the scaled image is
    smaller (the image with img_pad, label i with pad_values[i], else
    255) (the train transforms); a resize to resize_to (Cityscapes
    validation); neither (identity). hflip adds a random flip to any of
    them."""

    def __init__(self, *, scale_range: Optional[Tuple[float, float]] = None,
                 crop_size: Optional[Tuple[int, int]] = None,
                 pad_values: Sequence[int] = (),
                 img_pad: Tuple[int, int, int] = (124, 116, 104),
                 hflip: bool = False,
                 resize_to: Optional[Tuple[int, int]] = None,
                 emit_u8: bool = False, seed: int = 0):
        if (scale_range is None) != (crop_size is None):
            raise NotImplementedError(
                "a random scale without a crop, or a crop without a scale, "
                "serves no named transform and is not ported")
        if resize_to is not None and scale_range is not None:
            raise ValueError("resize_to and a random scaled crop exclude "
                             "each other")
        self.scale_range = scale_range
        self.crop_size = crop_size
        self.pad_values = list(pad_values)
        self.img_pad = img_pad
        self.hflip = hflip
        self.resize_to = resize_to
        self.emit_u8 = emit_u8
        self.rng = np.random.RandomState(seed)

    @property
    def random(self) -> bool:
        return self.scale_range is not None or self.hflip

    def draw(self, size_hw: Tuple[int, int]):
        """One item's random parameters (s, y0, x0, flip) for a source
        image of size_hw, in the JAX package's draw order; s, y0 and x0
        are None without a scaled crop."""
        s = y0 = x0 = None
        if self.scale_range is not None:
            s = self.rng.uniform(*self.scale_range)
            nh, nw = (int(round(n * s)) for n in size_hw)
            ch, cw = self.crop_size
            y0 = self.rng.randint(0, max(nh, ch) - ch + 1)
            x0 = self.rng.randint(0, max(nw, cw) - cw + 1)
        flip = bool(self.hflip and self.rng.rand() < 0.5)
        return s, y0, x0, flip

    def __call__(self, image: np.ndarray, labels: List[np.ndarray],
                 params=None):
        image = np.asarray(image)
        labels = [np.asarray(l) for l in labels]
        if params is None:
            params = self.draw(image.shape[:2])
        s, y0, x0, flip = params
        if self.resize_to is not None:
            image = resize_image(image, self.resize_to)
            labels = [resize_label(l, self.resize_to) for l in labels]
        elif self.scale_range is not None:
            image, labels = self._scaled_crop(image, labels, s, y0, x0)
        if flip:
            image = image[:, ::-1]
            labels = [l[:, ::-1] for l in labels]
        labels = [np.ascontiguousarray(l, np.int32) for l in labels]
        if self.emit_u8:
            return np.ascontiguousarray(image.transpose(2, 0, 1)), labels
        return normalize(image), labels

    def _scaled_crop(self, image, labels, s, y0, x0):
        """Scale by s, pad if needed and crop at (y0, x0) without making
        the scaled image: the image window goes through Pillow's box
        resample, the labels through the nearest grid of the full resize
        (data/transforms.py:205-249 of the JAX package)."""
        h0, w0 = image.shape[:2]
        nh, nw = int(round(h0 * s)), int(round(w0 * s))
        ch, cw = self.crop_size
        # the crop window within the scaled extent; the rest is padding
        oh, ow = min(ch, nh - y0), min(cw, nw - x0)
        sy, sx = h0 / nh, w0 / nw
        box = (x0 * sx, y0 * sy, (x0 + ow) * sx, (y0 + oh) * sy)
        # the source window the filter can read: box, bilinear support
        # (max(scale, 1) on downscales) and rounding slack; an integer
        # shift keeps the sampling arithmetic the same
        mgx = int(np.ceil(max(sx, 1.0))) + 2
        mgy = int(np.ceil(max(sy, 1.0))) + 2
        wx0 = max(int(np.floor(box[0])) - mgx, 0)
        wy0 = max(int(np.floor(box[1])) - mgy, 0)
        wx1 = min(int(np.ceil(box[2])) + mgx, w0)
        wy1 = min(int(np.ceil(box[3])) + mgy, h0)
        image = native.resize_bilinear_u8(
            image[wy0:wy1, wx0:wx1], (oh, ow),
            box=(box[0] - wx0, box[1] - wy0, box[2] - wx0, box[3] - wy0))
        yi = _pil_nearest_index(h0, nh)[y0:y0 + oh]
        xi = _pil_nearest_index(w0, nw)[x0:x0 + ow]
        labels = [native.gather2d(l, yi, xi) for l in labels]
        if oh < ch or ow < cw:
            image, labels = self._pad_to(image, labels, ch, cw)
        return image, labels

    def _pad_to(self, image, labels, ch, cw):
        """Bottom/right pad to (ch, cw): the image with img_pad per
        channel, label i with pad_values[i] (255 past the list)."""
        h, w = image.shape[:2]
        ph, pw = max(ch - h, 0), max(cw - w, 0)
        out = np.empty((h + ph, w + pw, 3), np.uint8)
        out[...] = np.asarray(self.img_pad, np.uint8)
        out[:h, :w] = image
        labels = [np.pad(l, ((0, ph), (0, pw)),
                         constant_values=self.pad_values[i]
                         if i < len(self.pad_values) else 255)
                  for i, l in enumerate(labels)]
        return out, labels


def get_train_transform(name: str, cfg, seed: int = 0) -> PairedTransform:
    """The recipe's named transforms and their 513 twins
    (dataloader/transform.py:5-171)."""
    crop = tuple(cfg.crop_size)
    u8 = getattr(cfg, "ship_uint8", False)
    if name in ("rescale_769_multi_notrg", "rescale_513_multi_notrg"):
        # image + [spx]; spx pads with nseg, an id never selected
        pads = [cfg.nseg]
    elif name in ("rescale_769_multi_ignore_notrg",
                  "rescale_513_multi_ignore_notrg"):
        # image + [GT, spx]
        pads = [cfg.ignore_idx, cfg.nseg]
    elif name in ("rescale_769_nospx", "rescale_513_notrg"):
        # stage 2: image + [pseudo-label map]
        pads = [cfg.ignore_idx]
    elif name in ("eval_spx", "eval_spx_identity"):
        return PairedTransform(seed=seed)
    else:
        raise KeyError(f"unknown transform {name!r}")
    return PairedTransform(scale_range=(0.5, 2.0), crop_size=crop,
                           pad_values=pads, hflip=True, emit_u8=u8,
                           seed=seed)


def get_val_transform(cfg, seed: int = 0) -> PairedTransform:
    """Cityscapes validation resizes to 1024x2048; other datasets pass
    through."""
    if cfg.dataset == "cityscapes":
        return PairedTransform(resize_to=(1024, 2048), seed=seed)
    return PairedTransform(seed=seed)
