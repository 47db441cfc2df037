"""Shared CLI wiring, the port's copy of mulactseg_tpu/cli/common.py:
config -> datasets -> active set (seed_everything, build_active_datasets
:32-140, the dominant arm :148-176, _build_val_dataset :179-200, the
mixed-scale arm :203-234, setup_run :237).

Every branch of the JAX package's is ported: the synthetic fixture; the
or_labeling loaders (region_cityscapes_or_tensor and its _ignore twin,
VOC's region_voc_or_tensor, the research multi-hot rewrites, or_plbl,
oracle and woignore, async and asyncv2, and the finer superpixel map the
hierarchy and mseg methods force); the dominant-labelling arm
(--no-or-labeling); the mixed-scale mseg loaders; SYNTHIA's validation
labels; and the statistics loaders of data/stats.py (count_all,
visualize_minor, dom_w_gt, dominant_all_sample), which wrap the labelled
set of whichever arm the flags pick (_wrap_stats, :134-146).
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
    encode_synthia,
    open_label_synthia,
)
from mulactseg_tpu_torch.data.stats import (
    RegionStatsDataset,
    stats_mode_for_loader,
)
from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset
from mulactseg_tpu_torch.data.transforms import (
    PairedTransform,
    get_train_transform,
    get_val_transform,
)
from mulactseg_tpu_torch.utils.logging import MetricsSink, get_file_logger

# the research rewrites, in the JAX package's order of precedence
_MULTIHOT_REWRITES = ("tinyfilter_recommend", "tinyfilter", "ratiofilter",
                      "ratiosample", "dominantsample", "toponebase")


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
    if loader.startswith("mseg"):
        return _build_mseg_datasets(cfg, encode)
    # the statistics loaders are named with or_labeling unset too (the
    # reference's figure-7 Dominant scripts), so they wrap either arm
    stats_mode = stats_mode_for_loader(loader)
    if not cfg.or_labeling:
        return _build_dominant_datasets(cfg, encode, stats_mode)

    tf_name = cfg.train_transform
    # the loaders whose item carries the GT or the pseudo-label map before
    # spx (the _ignore, oracle and or_plbl loaders) take the transform that
    # pads each with its own value (255, nseg)
    if (("ignore" in loader or "oracle" in loader or "or_plbl" in loader)
            and "ignore" not in tf_name):
        tf_name = tf_name.replace("_multi_", "_multi_ignore_")
    mh_transform = next((k for k in _MULTIHOT_REWRITES if k in loader), None)
    if mh_transform is None and "ratiofilt" in loader:
        # eval_region_cityscapes_ratiofilt_all: the ratiofilter rewrite
        mh_transform = "ratiofilter"
    plbl_dir = None
    if "or_plbl" in loader:
        # the previous round's saved pseudo labels, found from the resume
        # checkpoint as stage 2 finds them (region_cityscapes_or_plbl.py:
        # 17-23)
        from mulactseg_tpu_torch.plbl.generator import plbl_save_dir

        if not cfg.resume_checkpoint:
            raise ValueError(f"loader {loader!r} needs --resume-checkpoint "
                             "to locate the plbl_gen round directory")
        plbl_dir = plbl_save_dir(cfg.resume_checkpoint, cfg.plbl_type,
                                 f"{cfg.init_iteration:02d}")
    label = RegionDatasetOr(
        cfg, cfg.trg_datalist, cfg.region_dict, split="active-label",
        transform=get_train_transform(tf_name, cfg, seed=cfg.seed),
        encode_fn=encode,
        # woignore keeps 255 in spmask and in the oracle labels
        ignore_gt_in_spmask="ignore" in loader and "woignore" not in loader,
        load_smaller_spx=cfg.load_smaller_spx or "hier" in cfg.method
        or cfg.method.endswith("_mseg"),
        async_views="async" in loader,
        async_weak_hflip="asyncv2" in loader,
        weak_size=(1024, 2048) if cfg.dataset == "cityscapes" else None,
        multihot_transform=mh_transform,
        oracle_labels="oracle" in loader,
        oracle_keep_ignore="woignore" in loader,
        plbl_dir=plbl_dir)
    pool = RegionDatasetOr(cfg, cfg.trg_datalist, cfg.region_dict,
                           split="active-ulabel", transform=None,
                           encode_fn=encode,
                           multi_hot_cls=label.multi_hot_cls)
    label.suppix = {}
    label.im_idx = []
    if stats_mode is not None:
        label = _wrap_stats(cfg, label, stats_mode)
    return RegionActiveSet(cfg, pool, label), _build_val_dataset(cfg, encode)


def _wrap_stats(cfg, label, stats_mode):
    """The statistics loader of `stats_mode` over the arm's labelled set;
    its checkpoint predicts ignore when the resume checkpoint's path or
    the method names predignore."""
    return RegionStatsDataset(
        cfg, label, stats_mode,
        pred_ignore="predignore" in (cfg.resume_checkpoint or "")
        or "predignore" in cfg.method,
        seed=cfg.seed)


def _build_dominant_datasets(cfg, encode, stats_mode=None):
    """The dominant-labelling arm (--no-or-labeling; the reference's
    non-Or branch, dataloader/__init__.py:143-145): RegionDatasetDominant
    over the gtFine_dominant* PNGs that tools/label_assignment writes,
    with predignore, withgt and oracle (full supervision) from the loader
    name and the method, its labelled set wrapped by a statistics loader
    where stats_mode names one."""
    from mulactseg_tpu_torch.data.datasets import RegionDatasetDominant

    with_gt = "withgt" in cfg.loader
    pred_ignore = "predignore" in cfg.loader or "predignore" in cfg.method
    pads = [cfg.ignore_idx, cfg.nseg] + ([cfg.ignore_idx] if with_gt
                                         else [])
    train_tf = PairedTransform(scale_range=(0.5, 2.0),
                               crop_size=tuple(cfg.crop_size),
                               pad_values=pads, hflip=True, seed=cfg.seed)
    label = RegionDatasetDominant(
        cfg, cfg.trg_datalist, cfg.region_dict, split="active-label",
        transform=train_tf, encode_fn=encode, pred_ignore=pred_ignore,
        with_gt=with_gt, full_supervision="oracle" in cfg.loader)
    pool = RegionDatasetDominant(
        cfg, cfg.trg_datalist, cfg.region_dict, split="active-ulabel",
        transform=None, encode_fn=encode)
    if stats_mode is not None:
        label = _wrap_stats(cfg, label, stats_mode)
    return RegionActiveSet(cfg, pool, label), _build_val_dataset(cfg, encode)


def _build_val_dataset(cfg, encode):
    """The validation dataset, or None where the datalist is absent; gta5
    shares the Cityscapes table, SYNTHIA has its own table and reads the
    first channel of its label PNGs."""
    val_list = cfg.val_datalist or os.path.join(cfg.datalist_dir, "val.txt")
    if not os.path.exists(val_list):
        if cfg.val_datalist:
            # an explicitly requested list must not silently disable
            # validation for a whole run
            raise FileNotFoundError(
                f"--val_datalist {cfg.val_datalist!r} does not exist")
        return None
    label_opener = None
    if cfg.dataset == "synthia":
        encode, label_opener = encode_synthia, open_label_synthia
    elif cfg.dataset == "gta5":
        encode = encode_cityscapes
    return ValDataset(cfg, val_list, transform=get_val_transform(cfg),
                      encode_fn=encode, label_opener=label_opener)


def _build_mseg_datasets(cfg, encode):
    """The mixed-scale arm (mseg_region_cityscapes.py:77-87): each level's
    datalist and region dict are the previous level's paths with the nseg
    token swapped; each level's superpixel map pads with its own nseg."""
    from mulactseg_tpu_torch.active.mseg_active_set import MsegRegionActiveSet
    from mulactseg_tpu_torch.data.datasets import RegionDatasetMseg

    levels = sorted(int(n) for n in cfg.nseg_list)
    if not levels:
        raise ValueError("mseg loader requires --nseg-list")
    datalists, region_dicts = {}, {}
    dl, rd, cur = cfg.trg_datalist, cfg.region_dict, str(cfg.nseg)
    for nseg in levels:
        dl = dl.replace(cur, str(nseg))
        rd = rd.replace(cur, str(nseg))
        cur = str(nseg)
        datalists[nseg], region_dicts[nseg] = dl, rd
    train_tf = PairedTransform(scale_range=(0.5, 2.0),
                               crop_size=tuple(cfg.crop_size),
                               pad_values=levels, hflip=True, seed=cfg.seed)
    label = RegionDatasetMseg(cfg, datalists, region_dicts,
                              split="active-label", transform=train_tf,
                              encode_fn=encode)
    pool = RegionDatasetMseg(cfg, datalists, region_dicts,
                             split="active-ulabel", transform=None,
                             encode_fn=encode,
                             multi_hot_by_nseg=label.mseg_mh_cls)
    val = _build_val_dataset(cfg, encode)
    return MsegRegionActiveSet(cfg, pool, label, root=cfg.data_root), val


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
