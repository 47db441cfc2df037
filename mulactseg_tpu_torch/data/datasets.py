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
import dataclasses
import json
import os
import pickle
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from mulactseg_tpu_torch.data.constants import (
    ID_TO_TRAIN_ID,
    SYN_ID_TO_TRAIN_ID,
)
from mulactseg_tpu_torch.data.transforms import PairedTransform, normalize
from mulactseg_tpu_torch.utils import jpeg
from mulactseg_tpu_torch.utils.png import (
    png_size,
    read_channel0,
    read_gray,
    read_rgb8,
)

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


def encode_synthia(target: np.ndarray) -> np.ndarray:
    """SYNTHIA raw id -> Cityscapes train id; ids past the table are 255
    (the reference's SYNTHIA encode_target)."""
    t = np.asarray(target, dtype=np.int64)
    safe = np.clip(t, 0, len(SYN_ID_TO_TRAIN_ID) - 1)
    out = SYN_ID_TO_TRAIN_ID[safe].astype(np.int32)
    return np.where(t >= len(SYN_ID_TO_TRAIN_ID), 255, out)


def open_label_synthia(path: str) -> np.ndarray:
    """A SYNTHIA GT PNG's class id: its first channel cast to uint8, as
    the JAX package takes it from Pillow (datasets.py:159-171); 8- and
    16-bit greyscale, palette and 8-bit colour files. Pillow reads a
    16-bit colour file at 8 bits; the port's reader refuses one."""
    return read_channel0(path).astype(np.uint8)


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
    recipe's region_cityscapes_or_tensor and its twins. split
    'active-label' gives training items (images, target, spx, spmask,
    target_bits; labels with the GT), 'active-ulabel' pool items (images,
    spx, target). The multi-hot file is memory-mapped, so a loader worker
    maps it again rather than receiving a copy. Options, as the JAX
    package's (datasets.py:189-402):
      - ignore_gt_in_spmask: GT == 255 pixels leave spmask (the _ignore
        loaders);
      - load_smaller_spx: also 'spx_small', the finer map at the path
        with seeds_{nseg} -> seeds_{small_nseg};
      - async_views: also an unaugmented weak view of the whole image
        resized to weak_size ('images_weak', 'spx_weak', 'spmask_weak',
        'spx_small_weak'), through a transform of its own seeded
        cfg.seed + 7919, which flips at random with async_weak_hflip
        (the asyncv2 loader);
      - multihot_transform: a research rewrite of the multi-hot tensor
        from the GT class sizes sp_gt_size.npy (data/research_filters);
      - oracle_labels: 'labels' is the GT inside spmask (255 inside ->
        the extra class, unless oracle_keep_ignore), 255 outside;
      - plbl_dir: 'labels' is the saved pseudo-label map
        <plbl_dir>/<label id>.png (the or_plbl loader)."""

    def __init__(self, cfg, datalist: str, region_dict: str, split: str,
                 transform: Optional[PairedTransform] = None,
                 encode_fn: Callable = encode_cityscapes,
                 multi_hot_cls: Optional[np.ndarray] = None,
                 load_gt: bool = False,
                 drop_last_channel: Optional[bool] = None,
                 ignore_gt_in_spmask: bool = False,
                 load_smaller_spx: bool = False,
                 async_views: bool = False,
                 weak_size: Optional[tuple] = None,
                 multihot_transform: Optional[str] = None,
                 sp_gt_size: Optional[np.ndarray] = None,
                 oracle_labels: bool = False,
                 async_weak_hflip: bool = False,
                 oracle_keep_ignore: bool = False,
                 plbl_dir: Optional[str] = None):
        self.cfg = cfg
        self.split = split
        self.transform = transform
        self.encode_fn = encode_fn
        self.ignore_gt_in_spmask = ignore_gt_in_spmask
        self.load_smaller_spx = load_smaller_spx
        self.async_views = async_views
        self.weak_size = weak_size
        if async_views:
            self._weak_tf = PairedTransform(
                resize_to=weak_size, hflip=async_weak_hflip,
                emit_u8=getattr(cfg, "ship_uint8", False),
                seed=cfg.seed + 7919)
        self.oracle_labels = oracle_labels
        self.oracle_keep_ignore = oracle_keep_ignore
        self.plbl_dir = plbl_dir
        self.load_gt = load_gt or ignore_gt_in_spmask or oracle_labels
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
        if multihot_transform:
            from mulactseg_tpu_torch.data.research_filters import (
                apply_multihot_transform,
            )

            if sp_gt_size is None:
                base = os.path.dirname(multi_hot_paths(cfg)["multi_hot_cls"])
                sp_gt_size = np.load(os.path.join(base, "sp_gt_size.npy"))
            sp_gt_size = sp_gt_size[..., :self.multi_hot_cls.shape[-1]]
            self.multi_hot_cls = apply_multihot_transform(
                multihot_transform, np.asarray(self.multi_hot_cls),
                np.asarray(sp_gt_size), cfg, seed=cfg.seed)
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

    def draw(self, index: int):
        """The strong view's parameters, and with async_views those of the
        weak view's own transform, (strong, weak)."""
        params = super().draw(index)
        if not self.async_views or self.split == "active-ulabel":
            return params
        weak = (self._weak_tf.draw(image_size(self.im_idx[index][0]))
                if self._weak_tf.random else None)
        return params, weak

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

        weak_params = None
        if self.async_views:
            params, weak_params = params
        spx_small = None
        if self.load_smaller_spx:
            spx_small = open_spx(spx_p.replace(
                f"seeds_{self.cfg.nseg}", f"seeds_{self.cfg.small_nseg}"))
        gt = self.encode_fn(open_label(lbl_p)) if self.load_gt else None
        plbl = None
        if self.plbl_dir is not None:
            lbl_id = os.path.basename(lbl_p).split(".")[0]
            plbl = open_label(os.path.join(self.plbl_dir, f"{lbl_id}.png"))
        # the JAX package's label order: [gt] [plbl] spx [spx_small]; the
        # transform pads label i with its i-th pad value
        named = [(k, v) for k, v in (("gt", gt), ("plbl", plbl),
                                     ("spx", spx), ("spx_small", spx_small))
                 if v is not None]
        if self.transform is not None:
            image, out = self.transform(image, [v for _, v in named], params)
        else:
            image = normalize(image)
            out = [v for _, v in named]
        got = {k: v.astype(np.int32) for (k, _), v in zip(named, out)}
        spx_t, gt_t = got["spx"], got.get("gt")
        selected = self.suppix.get(spx_p, [])
        spmask = spmask_from_selected(spx_t, selected, self.cfg.nseg)
        if self.ignore_gt_in_spmask:
            spmask &= gt_t != self.cfg.ignore_idx
        sample = {"images": image, "target": target, "spx": spx_t,
                  "spmask": spmask, "fnames": self.im_idx[index]}
        if target.shape[-1] <= 31:
            # per-pixel candidate bitmask (losses/fused.py)
            from mulactseg_tpu_torch.losses.fused import pixel_target_bits

            sample["target_bits"] = pixel_target_bits(target, spx_t, spmask)
        if spx_small is not None:
            sample["spx_small"] = got["spx_small"]
        if gt_t is not None:
            if self.oracle_labels:
                inside = (gt_t if self.oracle_keep_ignore else
                          np.where(gt_t == self.cfg.ignore_idx,
                                   self.cfg.num_classes, gt_t))
                sample["labels"] = np.where(
                    spmask, inside, self.cfg.ignore_idx).astype(np.int32)
            else:
                sample["labels"] = gt_t
        if plbl is not None:
            sample["labels"] = got["plbl"]
        if self.async_views:
            sample.update(self._weak_view(image_raw=open_image(img_p),
                                          labels=[v for k, v in named
                                                  if k != "plbl"],
                                          selected=selected,
                                          has_gt=gt is not None,
                                          params=weak_params))
        return sample

    def _weak_view(self, image_raw, labels, selected, has_gt, params):
        """The weak view's keys: the untransformed image and its [gt] spx
        [spx_small] through the weak transform."""
        img_w, out = self._weak_tf(image_raw, labels, params)
        gt_w = out.pop(0) if has_gt else None
        spx_w = out.pop(0)
        spmask_w = spmask_from_selected(spx_w, selected, self.cfg.nseg)
        if self.ignore_gt_in_spmask and gt_w is not None:
            spmask_w &= gt_w != self.cfg.ignore_idx
        weak = {"images_weak": img_w, "spx_weak": spx_w,
                "spmask_weak": spmask_w}
        if out:
            weak["spx_small_weak"] = out[0]
        return weak


class RegionDatasetMseg(_FileDataset):
    """Mixed-superpixel-scale region dataset (RegionDatasetMseg,
    datasets.py:403-527; the reference's mseg_region_cityscapes_or_tensor
    over mseg_region_cityscapes' merged datalists). Each image carries
    annotations at several granularities (cfg.nseg_list, ascending);
    im_idx entries are [img_path, {str(nseg): [lbl_path, spx_path]}], as
    active/mseg_active_set.MsegRegionActiveSet fills them, and suppix maps
    spx_path -> the selected ids. Items are padded to the whole level
    axis S: 'mseg_spx' (S, H, W) int32 (absent levels zero), 'mseg_spmask'
    (S, H, W) bool (absent levels all-False, so they add nothing to the
    loss), 'nseg_lbl' (S,) the levels present and 'mseg_target_<i>'
    (nseg_i, C + 1) each level's multi-hot row."""

    def __init__(self, cfg, datalists: Dict[int, str],
                 region_dicts: Dict[int, str], split: str,
                 transform: Optional[PairedTransform] = None,
                 encode_fn: Callable = encode_cityscapes,
                 multi_hot_by_nseg: Optional[Dict[int, np.ndarray]] = None):
        self.cfg = cfg
        self.split = split
        self.transform = transform
        self.encode_fn = encode_fn
        self.nseg_list = sorted(int(n) for n in cfg.nseg_list)
        if not self.nseg_list:
            raise ValueError("RegionDatasetMseg requires cfg.nseg_list")
        self.root = cfg.data_root
        # the levels' region dicts merged, under relative and full paths
        self.region: Dict[str, List[int]] = {}
        for nseg in self.nseg_list:
            for k, v in load_region_dict(region_dicts[nseg]).items():
                self.region[os.path.join(cfg.data_root, k)] = v
                self.region[k] = v
        self.mseg_mh_cls: Dict[int, np.ndarray] = {}
        self.id_to_index: Dict[int, Dict[str, int]] = {}
        lines: Dict[int, List[str]] = {}
        for nseg in self.nseg_list:
            with open(datalists[nseg]) as f:
                lines[nseg] = [l for l in f.read().splitlines() if l.strip()]
            if multi_hot_by_nseg is not None:
                self.mseg_mh_cls[nseg] = multi_hot_by_nseg[nseg]
            else:
                sub = dataclasses.replace(cfg, nseg=nseg)
                self.mseg_mh_cls[nseg] = np.load(
                    multi_hot_paths(sub)["multi_hot_cls"])
            self.id_to_index[nseg] = {
                os.path.basename(line.split("\t")[1]).split(".")[0]: i
                for i, line in enumerate(lines[nseg])}
        self.im_idx: List[list] = []
        self.suppix: Dict[str, List[int]] = {}
        if split in ("active-ulabel", "pool", "train"):
            # one entry per image with every level
            # (mseg_region_cityscapes.py:89-103)
            by_img: Dict[str, Dict[str, List[str]]] = {}
            for nseg in self.nseg_list:
                for line in lines[nseg]:
                    img, lbl, spx = (os.path.join(cfg.data_root, p)
                                     for p in line.split("\t"))
                    by_img.setdefault(img, {})[str(nseg)] = [lbl, spx]
                    self.suppix[spx] = list(self.region.get(spx, []))
            self.im_idx = [[img, d] for img, d in by_img.items()]

    def load(self, index: int, params) -> Dict:
        img_p, lbl_spx = self.im_idx[index]
        image = open_image(img_p)
        maps = [open_spx(lbl_spx[str(n)][1]) if str(n) in lbl_spx else None
                for n in self.nseg_list]
        present = np.asarray([m is not None for m in maps])
        shape = next(m for m in maps if m is not None).shape
        labels = [m if m is not None else np.zeros(shape, np.int32)
                  for m in maps]
        if self.transform is not None:
            image, labels = self.transform(image, labels, params)
        else:
            image = normalize(image)
        sample: Dict = {"images": image, "fnames": [img_p, lbl_spx],
                        "nseg_lbl": present}
        spx_stack, mask_stack = [], []
        for s, nseg in enumerate(self.nseg_list):
            spx = labels[s].astype(np.int32)
            mh = self.mseg_mh_cls[nseg]
            if present[s]:
                lbl_path, spx_path = lbl_spx[str(nseg)]
                mask = np.isin(spx, self.suppix.get(spx_path, []))
                stem = os.path.basename(lbl_path).split(".")[0]
                target = np.asarray(mh[self.id_to_index[nseg][stem]],
                                    np.float32)
            else:
                mask = np.zeros(spx.shape, bool)
                target = np.zeros(mh.shape[1:], np.float32)
            spx_stack.append(spx)
            mask_stack.append(mask)
            sample[f"mseg_target_{s}"] = target
        sample["mseg_spx"] = np.stack(spx_stack)
        sample["mseg_spmask"] = np.stack(mask_stack)
        return sample


class RegionDatasetDominant(_FileDataset):
    """The dominant-labelling baseline, the paper's 'Dominant' query arm
    (RegionDatasetDominant, datasets.py:528-655; the reference's
    region_cityscapes.py with dominant_labeling and its predignore /
    withgt / oracle twins):
      - the datalist's label paths name offline gtFine_dominant* PNGs
        (tools/label_assignment --mode dominant); with
        cfg.dominant_labeling they load raw (train ids and 255), else
        through encode_fn. Without cfg.known_ignore gtFine_dominant ->
        gtFine_dominant_ignore; with cfg.prob_dominant ->
        gtFine_dominant_ignore_sample (region_cityscapes.py:56-68);
      - unselected superpixels mask to 255;
      - pred_ignore: 255 -> the extra class C before the transform, so
        the crop padding stays 255;
      - with_gt: the precise GT rides along under 'target';
      - full_supervision: the labelled set starts as the whole datalist
        with every superpixel selected.
    A VOC datalist of bare image ids builds the VOC paths at seeds_{nseg}.
    """

    def __init__(self, cfg, datalist: Optional[str], region_dict: str,
                 split: str = "active-label",
                 transform: Optional[PairedTransform] = None,
                 encode_fn: Callable = encode_cityscapes,
                 *, pred_ignore: bool = False, with_gt: bool = False,
                 full_supervision: bool = False):
        self.cfg = cfg
        self.split = split
        self.transform = transform
        self.encode_fn = encode_fn
        self.pred_ignore = pred_ignore
        self.with_gt = with_gt
        region = load_region_dict(region_dict)
        self.im_idx: List[List[str]] = []
        self.suppix: Dict[str, List[int]] = {}
        if datalist is not None:
            with open(datalist) as f:
                lines = [l for l in f.read().splitlines() if l.strip()]
            for line in lines:
                cols = line.split("\t")
                if len(cols) == 1:
                    fid = cols[0]
                    seeds = f"superpixels/pascal_voc_seg/seeds_{cfg.nseg}"
                    img = f"VOC2012/JPEGImages/{fid}.jpg"
                    lbl = (f"{seeds}/train/gtFine_dominant/{fid}.png"
                           if cfg.dominant_labeling else
                           f"VOC2012/SegmentationClass/{fid}.png")
                    spx = f"{seeds}/train/label/{fid}.pkl"
                    rkey = fid
                else:
                    img, lbl, spx = cols
                    rkey = spx
                if not cfg.known_ignore:
                    lbl = lbl.replace("gtFine_dominant",
                                      "gtFine_dominant_ignore")
                if cfg.prob_dominant:
                    lbl = lbl.replace("gtFine_dominant",
                                      "gtFine_dominant_ignore_sample")
                full = [os.path.join(cfg.data_root, p)
                        for p in (img, lbl, spx)]
                self.im_idx.append(full)
                self.suppix[full[2]] = list(region[rkey])
        if not full_supervision and split == "active-label":
            # the labelled set starts empty; the active set fills it
            self.im_idx = []
            self.suppix = {}

    def load(self, index: int, params) -> Dict:
        img_p, lbl_p, spx_p = self.im_idx[index]
        image = open_image(img_p)
        spx = open_spx(spx_p)
        if self.split == "active-ulabel":
            if self.transform is not None:
                image, (spx,) = self.transform(image, [spx], params)
            else:
                image = normalize(image)
            return {"images": image, "spx": spx.astype(np.int32),
                    "fnames": self.im_idx[index]}
        raw = open_label(lbl_p)
        target = raw if self.cfg.dominant_labeling else self.encode_fn(raw)
        if self.pred_ignore:
            target = np.where(target == self.cfg.ignore_idx,
                              self.cfg.num_classes, target)
        labels = [target, spx]
        if self.with_gt:
            gt = self.encode_fn(open_label(self._gt_path(lbl_p)))
            if self.pred_ignore:
                gt = np.where(gt == self.cfg.ignore_idx,
                              self.cfg.num_classes, gt)
            labels.append(gt)
        if self.transform is not None:
            image, labels = self.transform(image, labels, params)
        else:
            image = normalize(image)
        target = np.asarray(labels[0]).astype(np.int32)
        spx = np.asarray(labels[1]).astype(np.int32)
        mask = np.isin(spx, np.asarray(self.suppix.get(spx_p, []), np.int64))
        sample = {"images": image,
                  "labels": np.where(mask, target,
                                     self.cfg.ignore_idx).astype(np.int32),
                  "spx": spx, "fnames": self.im_idx[index]}
        if self.with_gt:
            sample["target"] = np.asarray(labels[2]).astype(np.int32)
        return sample

    def _gt_path(self, lbl_p: str) -> str:
        """The precise GT of a dominant file, '{root}/gtFine/train/{city}/
        {id}_gtFine_labelIds.png' from its id (region_cityscapes_withgt.py:
        109-111)."""
        id_ = os.path.basename(lbl_p).split(".")[0]
        return os.path.join(self.cfg.data_root, "gtFine", "train",
                            id_.split("_")[0], f"{id_}_gtFine_labelIds.png")


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
    reference's dataloader/dataset.py conventions). label_opener reads a
    label file in place of open_label (open_label_synthia for SYNTHIA)."""

    def __init__(self, cfg, datalist: str,
                 transform: Optional[PairedTransform] = None,
                 encode_fn: Callable = encode_cityscapes,
                 label_opener: Optional[Callable] = None):
        self.cfg = cfg
        self.transform = transform
        self.encode_fn = encode_fn
        self.label_opener = label_opener
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
        gt = self.encode_fn((self.label_opener or open_label)(lbl_p))
        if self.transform is not None:
            image, (gt,) = self.transform(image, [gt], params)
        else:
            image = normalize(image)
        return {"images": image, "labels": gt.astype(np.int32),
                "fnames": self.im_idx[index]}
