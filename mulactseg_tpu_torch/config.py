"""Structured configuration (the port's own copy of mulactseg_tpu/config.py,
which is pure Python; kept identical so one Config drives both packages).

Replaces the reference's ~110-flag monolithic argparse
(its utils/common.py:208-370) with a dataclass keeping the
same semantic fields and defaults (Cityscapes stage-1 values from
script/open_source/train_city_mul_res50.sh), plus `preprocess`-style
path derivation (utils/common.py:142-175) and cross-field assertions
(arg_assert, :177-201). A CLI shim maps the reference flag names onto the
dataclass so the published recipes keep working.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


@dataclass
class Config:
    # --- model -------------------------------------------------------------
    model: str = "deeplabv3pluswn_resnet50deepstem"
    num_classes: int = 19
    output_stride: int = 16
    separable_conv: bool = False

    # --- plugins (string-keyed, like the reference importlib registry) -----
    method: str = "active_joint_multi_predignore_lossdecomp"
    loader: str = "region_cityscapes_or_tensor"
    active_method: str = "my_bvsb_predclsbal_pwr_banignore"
    init_active_method: str = "my_random"

    # --- dataset -----------------------------------------------------------
    dataset: str = "cityscapes"           # or "voc"
    data_root: str = "./data"
    datalist_dir: str = ""                # derived when empty
    trg_datalist: str = ""                # derived
    val_datalist: str = ""                # derived (datalist_dir/val.txt)
    region_dict: str = ""                 # derived
    nseg: int = 2048
    # reference default 2048 == nseg (common.py:352) — the hier smaller-
    # spx substitution is a no-op unless --small_nseg is passed
    small_nseg: int = 2048
    # force loading the finer superpixel map regardless of method name
    # (reference --load_smaller_spx, region_cityscapes_or_tensor.py:76-80)
    load_smaller_spx: bool = False
    # legacy region_cityscapes_or on-disk format selector ('binary' /
    # 'tensor' / 'dictionary', region_cityscapes_or.py:69-78); every
    # shipped script uses the or_tensor (S, C) multi-hot layout this
    # reader implements — accepted for CLI parity
    loading: str = "binary"
    # mixed-scale superpixels, ascending (utils/common.py:334; when set the
    # reference forces nseg = nseg_list[-1], common.py:149-150)
    nseg_list: Tuple[int, ...] = ()
    spx_method: str = "seeds"
    ignore_idx: int = 255
    or_labeling: bool = True
    dominant_labeling: bool = False
    # dominant-baseline datalist variants (region_cityscapes.py:56-68):
    # without known_ignore the label paths rewrite gtFine_dominant ->
    # gtFine_dominant_ignore; prob_dominant -> gtFine_dominant_ignore_sample
    known_ignore: bool = False
    prob_dominant: bool = False
    trim_multihot_boundary: bool = True
    trim_kernel_size: int = 5
    # CLI-parity flags whose only reference consumer
    # (region_cityscapes_or_all.py) is dead code there — its class name is
    # unreachable by the dataloader dispatch and no script selects it
    ignore_size: int = 0
    mark_topk: int = -1
    # research-loader multi-hot rewrites (*_tinyfilter_gt etc.;
    # utils/common.py:251-252)
    multihot_filter_size: int = 0
    multihot_filter_ratio: float = 0.0
    train_transform: str = "rescale_769_multi_notrg"
    val_transform: str = "eval"
    label_encoding: str = "auto"         # auto|identity|cityscapes
    crop_size: Tuple[int, int] = (768, 768)

    # --- training ----------------------------------------------------------
    optimizer: str = "adamw"
    train_lr: float = 2e-5
    cls_lr_scale: float = 10.0
    # the reference DEFAULT is 1e-5 — its argparse help string claims
    # 5e-4 but the default= is 1e-5 (utils/common.py:319), and the paper
    # recipes never override it
    weight_decay: float = 1e-5
    scheduler: str = "poly"
    power: float = 0.9
    min_lr: float = 1e-6
    finetune_itrs: int = 80_000
    val_period: int = 10_000
    val_start: int = 0           # first iteration eligible for validation
    log_period: int = 1000       # metric log cadence (utils/common.py:363)
    # reference --total_itrs: shadowed in practice — trainer/base.py:41-44
    # prefers finetune_itrs, which always exists; accepted for CLI parity
    total_itrs: int = 0
    freeze_bn: bool = False      # train with BN modules in eval mode
    # lr = train_lr * selection_iter when set (trainer/active.py:30-33)
    adaptive_train_lr: bool = False
    train_batch_size: int = 4
    val_batch_size: int = 4
    num_workers: int = 8
    val_num_workers: int = 8
    loss_type: str = "joint_multi_loss"
    ce_temp: float = 0.1
    multi_ce_temp: float = 0.1
    group_ce_temp: float = 0.1
    coeff: float = 16.0
    coeff_mc: float = 8.0
    coeff_gm: float = 1.0
    group_only_single: bool = False
    gumbel_scale: float = -1.0
    entcoeff: float = 1.0       # multient trainer entropy weight
    simw_temp: float = 0.1      # pwce similarity temp (common.py:236)
    # pwce warmup: simw_temp pinned to 1000 for the first 20k iterations
    # (active_pwce_multi_predignore.py:193-198)
    simw_temp_schedule: bool = False
    # async-weight hier: segment reduce of the weak-view probabilities
    # ('max' or 'mean', utils/loss.py:238-240,320)
    weight_reduce: str = "max"
    # hier trainers swap in the border-stripping Aug variant
    # (active_joint_hier_multi.py:14-17)
    nocropsp: bool = False
    # wplbl: hard-gate pixels by weight > th instead of weighting
    # (active_onlinewplbl_multi_predignore.py:137-140)
    th_wplbl: Optional[float] = None
    # wplbl: weight forced to 1 at prototype source pixels
    # (active_onlinewplbl_multi_predignore.py:120-121)
    weight_wo_proto: bool = False
    within_filtering: bool = False  # top1plbl candidate renormalization
    plbl_th: float = 0.0        # top1plbl confidence threshold
    lamparam: float = 0.1       # online-plbl ramp damping (utils/scheduler.py:15-28)
    lamscale: float = 1.0
    # reference --dorampup is store_true default False (common.py:249);
    # no shipped script enables it
    dorampup: bool = False

    # --- active learning protocol -------------------------------------------
    max_iterations: int = 5
    active_selection_size: int = 100_000
    init_iteration: int = 1
    start_over: bool = True
    fair_counting: bool = True
    cls_weight_coeff: float = 8.0
    save_scores: bool = False
    # skip the sanity eval at the first (resumed) round's start
    # (train_AL.py:59-60)
    skip_first_eval: bool = False
    # 'region' is the only mode the reference implements — 'scan' raises
    # NotImplementedError upstream (dataloader/__init__.py:135-136)
    active_mode: str = "region"

    # --- sliding-window eval (utils/sliding_evaluator.py) --------------------
    sliding_eval: bool = False
    slide_crop: int = 800
    slide_stride_rate: float = 0.6667

    # --- stage 2 / pseudo labels --------------------------------------------
    stage2: bool = False
    plbl_type: Optional[str] = None
    cosprop_threshold_method: str = "median"
    save_vis: bool = False

    # --- checkpoints / resume ------------------------------------------------
    # reference stage-1 auto-naming: expand -p into the descriptive
    # '{p}_{active_method}_sp{nseg}_nlbl..k_iter..k_method-..-_...' dir and
    # bump a numeric suffix if it already exists (utils/common.py:118-140,
    # gen_save_name + avoid_duplication). Opt-in here so explicit -p dirs
    # stay stable; the reference applies it to every non-stage2 run.
    auto_name: bool = False
    model_save_dir: str = "./checkpoints/run0"
    init_checkpoint: str = ""
    resume_checkpoint: str = ""
    datalist_path: str = ""
    # resuming a round also restores the optimizer state + step
    # (trainer/base.py:288-295 load_checkpoint(load_optimizer=...))
    load_optim: bool = False

    # --- logging (wandb flags, utils/common.py:345-350) ----------------------
    use_wandb: bool = False
    dontlog: bool = False        # reference --dontlog: wandb dryrun/no-op
    session_name: str = ""
    wandb_tags: tuple = ()       # reference --wandb_tags nargs='+'
    wandb_group: str = ""        # reference --wandb_group

    # --- system ---------------------------------------------------------------
    steps_per_dispatch: int = 1   # >1: device-side lax.scan over K steps
    # train loader emits uint8 crops and normalization moves on-device
    # (engine/train._build_loss_fn): 4x less host stacking + transfer per
    # super-batch. Off by default pending a measured TPU win.
    ship_uint8: bool = False
    seed: int = 0
    dtype: str = "bfloat16"              # compute dtype for conv stack
    profile: bool = False
    debug_nans: bool = False
    n_devices: Optional[int] = None      # data-parallel width (None = all)

    @property
    def num_model_classes(self) -> int:
        """predignore methods add one 'undefined' output class
        (trainer/active_joint_multi_predignore.py:139-144); the eval /
        plbl-generation trainers do too on non-VOC datasets
        (eval_naive.py:18-23, eval_save_cosplbl_prop.py get_al_model),
        while their *_voc twins keep the plain 21-class model."""
        if "predignore" in self.method:
            return self.num_classes + 1
        if self.method.startswith("eval") and "_voc" not in self.method \
                and self.dataset != "voc":
            return self.num_classes + 1
        return self.num_classes

    def validate(self):
        """arg_assert equivalents (utils/common.py:177-201)."""
        if not self.loader.startswith("synthetic"):
            if self.dataset == "voc":
                assert self.num_classes == 21
            if self.dataset == "cityscapes":
                assert self.num_classes == 19
        if self.or_labeling and not self.stage2:
            assert "or" in self.loader or "tensor" in self.loader or \
                self.loader.startswith("synthetic")
        if "plbl" in self.loader and "or_plbl" not in self.loader:
            # or_plbl is a stage-1 loader (sequence training); the plain
            # plbl loaders are the stage-2 retrain path
            assert self.stage2
        assert self.train_batch_size >= 1
        if self.active_mode != "region":
            # 'scan' raises NotImplementedError in the reference too
            # (dataloader/__init__.py:135-136)
            raise NotImplementedError(
                f"active_mode {self.active_mode!r}: only 'region' exists")

    def derive_paths(self):
        """preprocess equivalents (utils/common.py:142-175)."""
        if not self.datalist_dir:
            self.datalist_dir = f"dataloader/init_data/{self.dataset}"
        if not self.trg_datalist:
            self.trg_datalist = os.path.join(
                self.datalist_dir, f"train_seed{self.nseg}.txt")
        if self.dominant_labeling and "dominant" not in self.trg_datalist:
            # dominant arm uses the *_dominant datalists whose label paths
            # point at the offline gtFine_dominant PNGs (common.py:165-167)
            self.trg_datalist = (self.trg_datalist.rsplit(".", 1)[0]
                                 + "_dominant.txt")
        if not self.region_dict:
            self.region_dict = os.path.join(self.datalist_dir, "train.dict")
        if self.auto_name and not self.stage2:
            # gen_save_name (utils/common.py:118-130)
            self.model_save_dir = (
                f"{self.model_save_dir}_{self.active_method}_sp{self.nseg}"
                f"_nlbl{self.active_selection_size / 1000}k"
                f"_iter{self.finetune_itrs / 1000}k_method-{self.method}-"
                f"_coeff{self.coeff}_ign{self.known_ignore}"
                f"_lr{self.train_lr}_")
            # avoid_duplication (utils/common.py:132-140): bump a numeric
            # suffix until the directory is fresh
            while (os.path.exists(self.model_save_dir)
                   and "naive" not in self.model_save_dir):
                tail = self.model_save_dir[-1]
                if tail.isnumeric():
                    self.model_save_dir = (self.model_save_dir[:-1]
                                           + str(int(tail) + 1))
                else:
                    self.model_save_dir += "_1"
        return self


def voc_defaults(cfg: Optional[Config] = None) -> Config:
    """VOC recipe defaults (utils/common_voc.py diff: 21 classes, nseg 150,
    batch 12, 30k iters, crop 513, lr 1e-5)."""
    cfg = cfg or Config()
    return dataclasses.replace(
        cfg, dataset="voc", num_classes=21, nseg=150, small_nseg=600,
        train_batch_size=12, finetune_itrs=30_000, crop_size=(513, 513),
        train_lr=1e-5, active_selection_size=10_000,
        train_transform="rescale_513_multi_notrg",
        loader="region_voc_or_tensor")


def build_argparser() -> argparse.ArgumentParser:
    """CLI shim accepting BOTH flag spellings: this package's dashed names
    and the reference's underscored argparse names (utils/common.py), so
    the reference's script/open_source command lines run as-is. Booleans
    take an optional value (`--separable_conv` == `--separable-conv true`),
    and `-p` is the reference's model-save-dir shorthand
    (utils/common.py:359)."""
    p = argparse.ArgumentParser("mulactseg_tpu")
    for f in dataclasses.fields(Config):
        names = ["--" + f.name.replace("_", "-")]
        if "_" in f.name:
            names.append("--" + f.name)
        if f.name == "model_save_dir":
            # reference: '-p', '--model_save_dir' (utils/common.py:359)
            names = ["-p"] + names
            kw = {"dest": "model_save_dir"}
        elif f.name == "init_active_method":
            # the reference spells it --initial_active_method
            names.append("--initial_active_method")
            kw = {"dest": "init_active_method"}
        else:
            kw = {}
        if f.type == "bool" or isinstance(f.default, bool):
            # nargs='?': a bare flag means True (reference store_true
            # style); an explicit true/false value still parses
            p.add_argument(*names, nargs="?", const=True,
                           type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=f.default, **kw)
        elif f.name in ("crop_size",):
            p.add_argument(*names, type=int, nargs=2, default=f.default, **kw)
        elif f.name in ("nseg_list",):
            # reference: --nseg_list nargs='+' (utils/common.py:334)
            p.add_argument(*names, type=int, nargs="+", default=f.default,
                           **kw)
        elif f.name in ("wandb_tags",):
            # reference: --wandb_tags nargs='+' (utils/common.py:345)
            p.add_argument(*names, type=str, nargs="+", default=f.default,
                           **kw)
        elif f.name in ("th_wplbl",):
            # Optional[float] with default None
            p.add_argument(*names, type=float, default=None, **kw)
        elif f.default is None:
            p.add_argument(*names, default=None, **kw)
        else:
            p.add_argument(*names, type=type(f.default), default=f.default,
                           **kw)
    return p


def parse_config(argv: Optional[Sequence[str]] = None) -> Config:
    args = build_argparser().parse_args(argv)
    cfg = Config(**{f.name: getattr(args, f.name)
                    for f in dataclasses.fields(Config)})
    if isinstance(cfg.crop_size, list):
        cfg.crop_size = tuple(cfg.crop_size)
    if isinstance(cfg.nseg_list, list):
        cfg.nseg_list = tuple(sorted(cfg.nseg_list))
    if cfg.nseg_list:
        # the reference forces nseg to the largest level (common.py:149-150)
        cfg.nseg = cfg.nseg_list[-1]
    cfg.derive_paths()
    cfg.validate()
    return cfg
