"""File-backed datasets of the PyTorch port: the recipe's loaders, ported
from mulactseg_tpu/data/datasets.py with utils/png.py and utils/jpeg.py in
place of Pillow (images: PNG or baseline JPEG; labels: greyscale or
palette PNG, the PASCAL VOC format).

File formats (the reference's dataloader/region_cityscapes.py:48-153):
  - datalist .txt: three tab-separated paths per line (image, label,
    superpixels), relative to cfg.data_root;
  - region dict .json: {spx_path: [size, missing_ids]} or {spx_path: ids};
  - superpixel maps: 8- or 16-bit greyscale .png, .pkl (a dict with a
    'labels' array) or .npy;
  - multi_hot_cls.npy (N, nseg, C+1) and sp_size.npy, indexed by label
    file stem (multi_hot_paths; tools/label_assignment.py writes them).

Every dataset here reads files, so data/loader.DataProvider builds its
items in worker processes: `draw(index)` takes an item's random transform
parameters in the calling process (the PNG header gives the size), and
`load(index, params)` does the rest wherever it runs. `dataset[index]`
is load(index, draw(index)), the JAX package's item. Images are
channel-first (3, H, W), float32, or uint8 where the consumer normalises
(emit_u8, ship_uint8).
"""

from __future__ import annotations

import collections
import json
import os
import pickle
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from mulactseg_tpu_torch.data.constants import ID_TO_TRAIN_ID
from mulactseg_tpu_torch.data.transforms import PairedTransform, normalize
from mulactseg_tpu_torch.utils import jpeg
from mulactseg_tpu_torch.utils.png import png_size, read_gray, read_rgb8

_NOT_PORTED = "is not ported yet: ROADMAP.md queue A, item 18"


def load_region_dict(path: str) -> Dict[str, List[int]]:
    with open(path) as f:
        data = json.load(f)
    first = next(iter(data.values()))
    if not (isinstance(first, list) and len(first) == 2
            and isinstance(first[1], list)):
        return {k: list(v) for k, v in data.items()}
    out = {}
    for k, (size, missing) in data.items():
        gone = set(missing)
        out[k] = [i for i in range(size) if i not in gone]
    return out


class _DecodeCache:
    """Byte-capped LRU over decoded files: a round revisits its small
    labelled set for every step, so a file is decoded once while it fits.
    Cached arrays are read-only to their consumers, which copy before any
    change. Cap: MULACTSEG_DECODE_CACHE_MB (0 disables; default 2048).
    The cache is per process: each loader worker holds its own."""

    def __init__(self):
        self._d = collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def _cap(self) -> int:
        return int(os.environ.get("MULACTSEG_DECODE_CACHE_MB",
                                  "2048")) * 1024 * 1024

    def peek(self, key):
        with self._lock:
            return self._d.get(key)

    def get(self, key, loader):
        cap = self._cap()
        if cap <= 0:
            return loader()
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
        val = loader()
        with self._lock:
            if key not in self._d:
                self._d[key] = val
                self._bytes += val.nbytes
                while self._bytes > cap and len(self._d) > 1:
                    _, old = self._d.popitem(last=False)
                    self._bytes -= old.nbytes
        return val

    def clear(self):
        with self._lock:
            self._d.clear()
            self._bytes = 0


_decode_cache = _DecodeCache()


def spmask_from_selected(spx: np.ndarray, selected,
                         nseg: int) -> np.ndarray:
    """np.isin(spx, selected) for superpixel maps as a boolean table
    gather: ids are < nseg, plus the crop pad nseg, never selected."""
    lut = np.zeros(nseg + 1, bool)
    sel = np.asarray(selected, np.int64)
    if sel.size:
        lut[sel[sel < nseg]] = True
    return lut[np.minimum(spx, nseg)]


def _format(path: str) -> str:
    """'png' or 'jpeg', from the file's first bytes; anything else
    raises."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == b"\x89PNG\r\n\x1a\n":
        return "png"
    if head[:2] == b"\xff\xd8":
        return "jpeg"
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def _read_image(path: str) -> np.ndarray:
    if _format(path) == "jpeg":
        return jpeg.read_rgb8(path)
    return read_rgb8(path)


def open_image(path: str) -> np.ndarray:
    """Decoded RGB uint8 (H, W, 3) of a PNG or JPEG file (cached; treat as
    read-only)."""
    return _decode_cache.get(("img", path), lambda: _read_image(path))


def image_size(path: str):
    """(H, W) of an image file, from the cache or the file's header."""
    img = _decode_cache.peek(("img", path))
    if img is not None:
        return img.shape[:2]
    return jpeg.jpeg_size(path) if _format(path) == "jpeg" else png_size(path)


def open_label(path: str) -> np.ndarray:
    """Decoded raw label array of a greyscale or palette PNG (cached,
    before encoding; read-only)."""
    return _decode_cache.get(("lbl", path), lambda: read_gray(path))


def _open_spx_impl(path: str) -> np.ndarray:
    ext = path.rsplit(".", 1)[-1]
    if ext == "png":
        return read_gray(path).astype(np.int32)
    if ext == "pkl":
        with open(path, "rb") as f:
            arch = pickle.load(f)
        return np.asarray(arch["labels"], dtype=np.int32)
    if ext == "npy":
        arch = np.load(path, allow_pickle=True)
        if isinstance(arch, np.ndarray) and arch.dtype == object:
            arch = arch.item()
        if isinstance(arch, dict):
            return np.asarray(arch["labels"], dtype=np.int32)
        return np.asarray(arch, dtype=np.int32)
    raise ValueError(f"unsupported superpixel file {path}")


def open_spx(path: str) -> np.ndarray:
    return _decode_cache.get(("spx", path), lambda: _open_spx_impl(path))


def encode_cityscapes(target: np.ndarray) -> np.ndarray:
    return ID_TO_TRAIN_ID[np.asarray(target, dtype=np.int64)].astype(np.int32)


def encode_identity(target: np.ndarray) -> np.ndarray:
    return np.asarray(target, dtype=np.int32)


def multi_hot_paths(cfg) -> Dict[str, str]:
    """Where the multi-hot tensors of the training set live (the
    reference's region_cityscapes_or_tensor.py:27-34 and
    region_voc_or_tensor.py:38-43)."""
    name = ("gtFine_multi_tensor_trim_{k}x{k}".format(k=cfg.trim_kernel_size)
            if cfg.trim_multihot_boundary else "gtFine_multi_tensor")
    if cfg.dataset == "voc":
        base = os.path.join(cfg.data_root, "superpixels", "pascal_voc_seg",
                            f"{cfg.spx_method}_{cfg.nseg}", "train",
                            name if cfg.trim_multihot_boundary else "multihot")
    else:
        base = os.path.join(cfg.data_root, "superpixel_seed", cfg.dataset,
                            f"{cfg.spx_method}_{cfg.nseg}", "train", name)
    return {"multi_hot_cls": os.path.join(base, "multi_hot_cls.npy"),
            "sp_size": os.path.join(base, "sp_size.npy")}


class _FileDataset:
    """draw/load split of an item (module docstring)."""

    reads_files = True
    transform: Optional[PairedTransform] = None

    def __len__(self):
        return len(self.im_idx)

    def draw(self, index: int):
        if self.transform is None or not self.transform.random:
            return None
        return self.transform.draw(image_size(self.im_idx[index][0]))

    def __getitem__(self, index: int) -> Dict:
        return self.load(index, self.draw(index))


class RegionDatasetOr(_FileDataset):
    """Region dataset with precomputed multi-hot annotations
    (RegionCityscapesOr, region_cityscapes_or_tensor.py:16-96), the
    recipe's region_cityscapes_or_tensor and its _ignore twin
    (ignore_gt_in_spmask: GT == 255 pixels leave spmask). split
    'active-label' gives training items (images, target, spx, spmask,
    target_bits; labels with the GT), 'active-ulabel' pool items (images,
    spx, target). The multi-hot file is memory-mapped, so a loader worker
    maps it again rather than receiving a copy."""

    def __init__(self, cfg, datalist: str, region_dict: str, split: str,
                 transform: Optional[PairedTransform] = None,
                 encode_fn: Callable = encode_cityscapes,
                 multi_hot_cls: Optional[np.ndarray] = None,
                 load_gt: bool = False,
                 drop_last_channel: Optional[bool] = None,
                 ignore_gt_in_spmask: bool = False,
                 load_smaller_spx: bool = False,
                 async_views: bool = False,
                 multihot_transform: Optional[str] = None,
                 oracle_labels: bool = False,
                 plbl_dir: Optional[str] = None):
        for on, what in ((load_smaller_spx, "load_smaller_spx (the finer "
                          "superpixel map)"),
                         (async_views, "async_views (the weak full view)"),
                         (multihot_transform, "multihot_transform (the "
                          "research multi-hot rewrites)"),
                         (oracle_labels, "oracle_labels (the oracle "
                          "loaders)"),
                         (plbl_dir, "plbl_dir (the or_plbl loader)")):
            if on:
                raise NotImplementedError(f"RegionDatasetOr {what} "
                                          + _NOT_PORTED)
        self.cfg = cfg
        self.split = split
        self.transform = transform
        self.encode_fn = encode_fn
        self.ignore_gt_in_spmask = ignore_gt_in_spmask
        self.load_gt = load_gt or ignore_gt_in_spmask
        region = load_region_dict(region_dict)
        self.im_idx: List[List[str]] = []
        self.suppix: Dict[str, List[int]] = {}
        with open(datalist) as f:
            lines = [l for l in f.read().splitlines() if l.strip()]
        for line in lines:
            img, lbl, spx = line.split("\t")
            full = [os.path.join(cfg.data_root, p) for p in (img, lbl, spx)]
            self.im_idx.append(full)
            self.suppix[full[2]] = list(region[spx])
        if multi_hot_cls is not None:
            self.multi_hot_cls = multi_hot_cls
        else:
            self.multi_hot_cls = np.load(multi_hot_paths(cfg)["multi_hot_cls"],
                                         mmap_mode="r")
            # VOC drops the trailing ignore channel
            # (region_voc_or_tensor.py:53)
            if drop_last_channel is None:
                drop_last_channel = cfg.dataset == "voc"
            if drop_last_channel:
                self.multi_hot_cls = self.multi_hot_cls[:, :, :-1]
        self.isselected = np.zeros(self.multi_hot_cls.shape[:-1], np.float32)
        self.id_to_index = {}
        for index, line in enumerate(lines):
            lbl = line.split("\t")[1]
            self.id_to_index[os.path.basename(lbl).split(".")[0]] = index

    def __getstate__(self):
        state = dict(self.__dict__)
        mh = self.multi_hot_cls
        if isinstance(mh, np.memmap) and mh.filename and \
                mh.shape == np.load(mh.filename, mmap_mode="r").shape:
            state["multi_hot_cls"] = ("mmap", mh.filename)
        return state

    def __setstate__(self, state):
        mh = state["multi_hot_cls"]
        if isinstance(mh, tuple):
            state["multi_hot_cls"] = np.load(mh[1], mmap_mode="r")
        self.__dict__.update(state)

    def _target_index(self, lbl_path: str) -> int:
        return self.id_to_index[os.path.basename(lbl_path).split(".")[0]]

    def load(self, index: int, params) -> Dict:
        img_p, lbl_p, spx_p = self.im_idx[index]
        image = open_image(img_p)
        spx = open_spx(spx_p)
        target = np.asarray(self.multi_hot_cls[self._target_index(lbl_p)],
                            np.float32)

        if self.split == "active-ulabel":
            if self.transform is not None:
                image, (spx,) = self.transform(image, [spx], params)
            elif getattr(self.cfg, "ship_uint8", False):
                image = np.ascontiguousarray(image.transpose(2, 0, 1))
            else:
                image = normalize(image)
            return {"images": image, "spx": spx.astype(np.int32),
                    "target": target, "fnames": self.im_idx[index]}

        gt = self.encode_fn(open_label(lbl_p)) if self.load_gt else None
        labels = ([gt] if gt is not None else []) + [spx]
        if self.transform is not None:
            image, labels = self.transform(image, labels, params)
        else:
            image = normalize(image)
        gt_t = labels[0].astype(np.int32) if gt is not None else None
        spx = labels[-1].astype(np.int32)
        selected = self.suppix.get(spx_p, [])
        spmask = spmask_from_selected(spx, selected, self.cfg.nseg)
        if self.ignore_gt_in_spmask:
            spmask &= gt_t != self.cfg.ignore_idx
        sample = {"images": image, "target": target, "spx": spx,
                  "spmask": spmask, "fnames": self.im_idx[index]}
        if target.shape[-1] <= 31:
            # per-pixel candidate bitmask (losses/fused.py)
            from mulactseg_tpu_torch.losses.fused import pixel_target_bits

            sample["target_bits"] = pixel_target_bits(target, spx, spmask)
        if gt_t is not None:
            sample["labels"] = gt_t
        return sample


class EvalRegionDatasetAll(_FileDataset):
    """Full-resolution loader of the labelled set for pseudo-labelling
    (eval_region_cityscapes_all.py:10-69): the precise GT with 255 mapped
    to the extra class, no transform, spmask over the selected ids.
    remove_dominant drops superpixels with a single candidate class from
    spmask (the analysis evals); mask_unselected 255-masks the GT outside
    spmask (eval_region_cityscapes_withinmulti.py:61); emit_u8 hands the
    uint8 image on, for a consumer that normalises on the device."""

    def __init__(self, cfg, base: RegionDatasetOr,
                 suppix: Dict[str, List[int]], *,
                 remove_dominant: bool = False,
                 mask_unselected: bool = False, emit_u8: bool = False):
        self.cfg = cfg
        self.base = base
        self.suppix = suppix
        self.remove_dominant = remove_dominant
        self.mask_unselected = mask_unselected
        self.emit_u8 = emit_u8
        self.im_idx = sorted([k for k in base.im_idx if k[2] in suppix])

    def load(self, index: int, params) -> Dict:
        img_p, lbl_p, spx_p = self.im_idx[index]
        image = open_image(img_p)
        image = (np.ascontiguousarray(image.transpose(2, 0, 1))
                 if self.emit_u8 else normalize(image))
        gt = self.base.encode_fn(open_label(lbl_p))
        gt = np.where(gt == self.cfg.ignore_idx, self.cfg.num_classes,
                      gt).astype(np.int32)
        spx = open_spx(spx_p)
        target = np.asarray(
            self.base.multi_hot_cls[self.base._target_index(lbl_p)],
            np.float32)
        selected = np.asarray(self.suppix.get(spx_p, []), np.int64)
        if self.remove_dominant and selected.size:
            selected = selected[target[selected].sum(-1) != 1]
        spmask = np.isin(spx, selected)
        if self.mask_unselected:
            gt = np.where(spmask, gt, self.cfg.ignore_idx).astype(np.int32)
        return {"images": image, "labels": gt, "spx": spx.astype(np.int32),
                "spmask": spmask, "target": target,
                "fnames": [img_p, lbl_p, spx_p]}


class RegionDatasetPlbl(_FileDataset):
    """Stage-2 loader (region_cityscapes_plbl.py:18-48): each labelled
    image with its saved pseudo-label PNG, <plbl_dir>/<label id>.png, as
    the dense training target, through `transform` (the recipe's
    rescale_769_nospx) or, without one, normalised at full size."""

    def __init__(self, cfg, im_idx: List[List[str]], plbl_dir: str,
                 transform: Optional[PairedTransform] = None):
        self.cfg = cfg
        self.im_idx = list(im_idx)
        self.plbl_dir = plbl_dir
        self.transform = transform
        self.suppix: Dict[str, List[int]] = {}

    def load(self, index: int, params) -> Dict:
        img_p, lbl_p, _ = self.im_idx[index]
        image = open_image(img_p)
        lbl_id = os.path.basename(lbl_p).split(".")[0]
        plbl = open_label(os.path.join(self.plbl_dir, f"{lbl_id}.png"))
        if self.transform is not None:
            image, (plbl,) = self.transform(image, [plbl], params)
        else:
            image = normalize(image)
        return {"images": image, "labels": plbl.astype(np.int32),
                "fnames": self.im_idx[index]}


class ValDataset(_FileDataset):
    """Validation / evaluation pairs (image, GT) from a datalist (the
    reference's dataloader/dataset.py conventions)."""

    def __init__(self, cfg, datalist: str,
                 transform: Optional[PairedTransform] = None,
                 encode_fn: Callable = encode_cityscapes):
        self.cfg = cfg
        self.transform = transform
        self.encode_fn = encode_fn
        self.im_idx: List[List[str]] = []
        with open(datalist) as f:
            for line in f.read().splitlines():
                if not line.strip():
                    continue
                parts = line.split("\t")
                self.im_idx.append(
                    [os.path.join(cfg.data_root, p) for p in parts[:2]])

    def load(self, index: int, params) -> Dict:
        img_p, lbl_p = self.im_idx[index]
        image = open_image(img_p)
        gt = self.encode_fn(open_label(lbl_p))
        if self.transform is not None:
            image, (gt,) = self.transform(image, [gt], params)
        else:
            image = normalize(image)
        return {"images": image, "labels": gt.astype(np.int32),
                "fnames": self.im_idx[index]}
