"""Shared CLI wiring, the port's copy of mulactseg_tpu/cli/common.py:
config -> datasets -> active set (seed_everything, build_active_datasets
:32-140, _build_val_dataset :190, setup_run :237).

Ported: the synthetic fixture and the recipes' or_labeling branch
(region_cityscapes_or_tensor and its _ignore twin, the VOC recipe's
region_voc_or_tensor with identity label encoding, and the loader names
the recipes' eval and stage-2 commands pass through it:
eval_region_cityscapes_all, region_cityscapes_plbl, eval_region_voc_all_ms,
region_voc_plbl). The other branches raise, naming ROADMAP.md queue A,
item 18.
"""

from __future__ import annotations

import os
import random

import numpy as np

from mulactseg_tpu_torch.active import RegionActiveSet
from mulactseg_tpu_torch.data.datasets import (
    RegionDatasetOr,
    ValDataset,
    encode_cityscapes,
    encode_identity,
)
from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset
from mulactseg_tpu_torch.data.transforms import (
    get_train_transform,
    get_val_transform,
)
from mulactseg_tpu_torch.utils.logging import MetricsSink, get_file_logger

_NOT_PORTED = "is not ported yet: ROADMAP.md queue A, item 18"
# loader-name fragments of the analysis loaders (the JAX package's
# data/stats.py LOADER_MODES)
_STATS_LOADERS = ("count_all", "visualize_minor", "dom_w_gt",
                  "dominant_all_sample")
_MULTIHOT_REWRITES = ("tinyfilter_recommend", "tinyfilter", "ratiofilter",
                      "ratiosample", "dominantsample", "toponebase",
                      "ratiofilt")


def seed_everything(seed: int):
    random.seed(seed)
    np.random.seed(seed)


def build_active_datasets(cfg):
    """Returns (active_set, val_dataset). loader='synthetic' builds the
    in-memory fixture; otherwise the region readers over the files."""
    if cfg.loader.startswith("synthetic"):
        mk = lambda split: SyntheticRegionDataset(
            n_images=8, H=cfg.crop_size[0], W=cfg.crop_size[1],
            num_classes=cfg.num_classes, nseg=cfg.nseg, split=split,
            seed=cfg.seed)
        pool = mk("active-ulabel")
        label = mk("active-label")
        label.suppix = {}
        label.im_idx = []
        val = mk("val")
        return RegionActiveSet(cfg, pool, label), val

    if cfg.label_encoding == "identity":
        encode = encode_identity
    elif cfg.label_encoding == "cityscapes":
        encode = encode_cityscapes
    else:
        encode = (encode_cityscapes if cfg.dataset == "cityscapes"
                  else encode_identity)
    loader = cfg.loader
    for on, what in ((loader.startswith("mseg"), "the mixed-scale loaders "
                      "(RegionDatasetMseg, MsegRegionActiveSet)"),
                     (any(f in loader for f in _STATS_LOADERS),
                      "the analysis loaders (data/stats.py)"),
                     (not cfg.or_labeling, "the dominant-labelling arm "
                      "(RegionDatasetDominant)"),
                     (any(f in loader for f in _MULTIHOT_REWRITES),
                      "the research multi-hot rewrites "
                      "(data/research_filters.py)"),
                     (any(f in loader for f in ("or_plbl", "oracle",
                                                "async")),
                      "the or_plbl, oracle and async loaders")):
        if on:
            raise NotImplementedError(f"loader {loader!r}: {what} "
                                      + _NOT_PORTED)
    if cfg.load_smaller_spx or "hier" in cfg.method or \
            cfg.method.endswith("_mseg"):
        raise NotImplementedError("the finer superpixel map "
                                  "(load_smaller_spx) " + _NOT_PORTED)

    tf_name = cfg.train_transform
    # the _ignore loaders carry [GT, spx]: the transform pads each with
    # its own value (255, nseg)
    if "ignore" in loader and "ignore" not in tf_name:
        tf_name = tf_name.replace("_multi_", "_multi_ignore_")
    label = RegionDatasetOr(cfg, cfg.trg_datalist, cfg.region_dict,
                            split="active-label",
                            transform=get_train_transform(tf_name, cfg,
                                                          seed=cfg.seed),
                            encode_fn=encode,
                            ignore_gt_in_spmask="ignore" in loader)
    pool = RegionDatasetOr(cfg, cfg.trg_datalist, cfg.region_dict,
                           split="active-ulabel", transform=None,
                           encode_fn=encode,
                           multi_hot_cls=label.multi_hot_cls)
    label.suppix = {}
    label.im_idx = []
    return RegionActiveSet(cfg, pool, label), _build_val_dataset(cfg, encode)


def _build_val_dataset(cfg, encode):
    """The validation dataset, or None where the datalist is absent; gta5
    shares the Cityscapes table (synthia is item 18)."""
    if cfg.dataset == "synthia":
        raise NotImplementedError("the SYNTHIA label reader " + _NOT_PORTED)
    val_list = cfg.val_datalist or os.path.join(cfg.datalist_dir, "val.txt")
    if not os.path.exists(val_list):
        if cfg.val_datalist:
            # an explicitly requested list must not silently disable
            # validation for a whole run
            raise FileNotFoundError(
                f"--val_datalist {cfg.val_datalist!r} does not exist")
        return None
    if cfg.dataset == "gta5":
        encode = encode_cityscapes
    return ValDataset(cfg, val_list, transform=get_val_transform(cfg),
                      encode_fn=encode)


def setup_run(cfg):
    seed_everything(cfg.seed)
    os.makedirs(cfg.model_save_dir, exist_ok=True)
    logger = get_file_logger(cfg.model_save_dir)
    # --dontlog turns the wandb mirror off; the JSONL sink is always on
    sink = MetricsSink(cfg.model_save_dir,
                       use_wandb=cfg.use_wandb and not cfg.dontlog,
                       wandb_kwargs={"name": cfg.session_name or None,
                                     "tags": list(cfg.wandb_tags) or None,
                                     "group": cfg.wandb_group or None})
    return logger, sink
