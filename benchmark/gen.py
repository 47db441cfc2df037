"""The one traffic generator: a cell's items, made from `--seed` by the
parameters of its traffic file (`benchmark/traffic/<mix>.json`) and the
sizes of its configuration (`benchmark/configs/<config>.json`).

A source image is a blobby label map (`rules.blobby_labels`), its
superpixels (`rules.irregular_superpixels`), the multi-hot of the classes
under each superpixel (`rules.multi_hot_from_gt`) and the superpixels
selected at the mix's share. A training item is a crop of a source image at
a random scale in `scale_range`, cut and padded as the recipe's train
transform does (the image with its pad colour, superpixel ids with nseg),
flipped at random. A full-resolution item is the source
image itself. Every item draws its own sizes and ids from one
`RandomState`, so the same seed gives the same items.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from benchmark import rules

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
IGNORE = 255


def rng_of(seed: int, stream: int) -> np.random.RandomState:
    """A RandomState for one use of the seed: any whole number, folded
    into numpy's 32-bit seed space with the stream index."""
    s = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), stream])
    return np.random.RandomState(s.generate_state(1)[0])


LUT = ((np.arange(256, dtype=np.float32)[:, None] / 255.0 - MEAN) / STD).T


def normalize(img_u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> ImageNet-normalised (3, H, W) float32."""
    return np.stack([LUT[c].take(img_u8[..., c]) for c in range(3)])


class Source:
    """One source image: label map, superpixels, multi-hot, selection."""

    def __init__(self, rng, cfg: Dict, mix: Dict):
        H, W = mix["source_hw"]
        C, S = cfg["num_classes"], cfg["nseg"]
        cy, cx = mix["label_cells"]
        self.gt = rules.blobby_labels(rng, H, W, C, cy, cx,
                                      mix["ignore_share"])
        self.spx = rules.irregular_superpixels(H, W, S, rng)
        self.target = rules.multi_hot_from_gt(self.gt, self.spx, S, C)
        if cfg["target_channels"] == C:  # VOC drops the ignore channel
            self.target = self.target[:, :C]
        # the labelled set holds images with at least one selection
        while True:
            sel = rng.rand(S) < mix["selected_share"]
            if sel.any():
                break
        self.selected = np.nonzero(sel)[0]
        self.palette = rng.randint(0, 208, size=(C + 1, 3)).astype(np.uint8)
        self.C = C

    def pixels(self, gt: np.ndarray, noise: np.ndarray) -> np.ndarray:
        """(h, w, 3) uint8 image of a label map: each class's colour plus a
        noise tile of at least (h, w, 3) uint8 values below 48."""
        cls = np.where(gt == IGNORE, self.C, gt)
        h, w = gt.shape
        return self.palette[cls] + noise[:h, :w]


def _crop(rng, src: Source, cfg: Dict, mix: Dict, noise: np.ndarray):
    """(image u8, spx, gt) of one scaled random crop, padded to the crop."""
    h0, w0 = src.gt.shape
    ch = cw = cfg["crop"]
    s = rng.uniform(*mix["scale_range"])
    nh, nw = int(round(h0 * s)), int(round(w0 * s))
    y0 = rng.randint(0, max(nh, ch) - ch + 1)
    x0 = rng.randint(0, max(nw, cw) - cw + 1)
    flip = bool(mix["hflip"] and rng.rand() < 0.5)
    oh, ow = min(ch, nh - y0), min(cw, nw - x0)
    yi = rules.pil_nearest_index(h0, nh)[y0:y0 + oh]
    xi = rules.pil_nearest_index(w0, nw)[x0:x0 + ow]
    spx = np.full((ch, cw), cfg["nseg"], np.int32)
    spx[:oh, :ow] = src.spx.take(yi, 0).take(xi, 1)
    gt = np.full((ch, cw), IGNORE, np.int32)
    gt[:oh, :ow] = src.gt.take(yi, 0).take(xi, 1)
    img = np.empty((ch, cw, 3), np.uint8)
    img[...] = np.asarray(mix["img_pad"], np.uint8)
    img[:oh, :ow] = src.pixels(gt[:oh, :ow], noise)
    if flip:
        img, spx, gt = img[:, ::-1], spx[:, ::-1], gt[:, ::-1]
    return (np.ascontiguousarray(img), np.ascontiguousarray(spx),
            np.ascontiguousarray(gt))


def selected_mask(spx: np.ndarray, src: Source, S: int) -> np.ndarray:
    sel = np.zeros(S + 1, bool)
    sel[src.selected] = True
    return sel[np.minimum(spx, S)]


def stage1_item(rng, src: Source, cfg: Dict, mix: Dict, noise) -> Dict:
    img, spx, _ = _crop(rng, src, cfg, mix, noise)
    spmask = selected_mask(spx, src, cfg["nseg"])
    return {"images": normalize(img), "target": src.target, "spx": spx,
            "spmask": spmask,
            "target_bits": rules.pixel_target_bits(src.target, spx, spmask)}


def make_items(seed: int, cfg: Dict, mix: Dict) -> List[Dict]:
    """The cell's item pool: mix['items'] items from mix['source_images']
    source images (training crops, or the sources themselves for a
    full-resolution mix)."""
    rng = rng_of(seed, 0)
    sources = [Source(rng, cfg, mix) for _ in range(mix["source_images"])]
    hw = mix["source_hw"] if mix["kind"] == "plbl" else (cfg["crop"],) * 2
    noise = rng.randint(0, 48, size=tuple(hw) + (3,), dtype=np.uint8)
    if mix["kind"] == "plbl":
        for src in sources:
            src.image = src.pixels(src.gt, noise)
        return sources
    make = {"stage1": stage1_item}[mix["stage"]]
    return [make(rng, sources[i % len(sources)], cfg, mix, noise)
            for i in range(mix["items"])]
