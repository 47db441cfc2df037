"""loss_type string registry: the port of mulactseg_tpu/losses/registry.py
(the reference's BaseTrainer --loss-type, trainer/base.py:78-114). Each
entry builds fn(logits, batch) -> loss, or (group, pos) for the joint
type; logits are float32 NCHW.

The hierarchy entries read b['spx_small'], the finer superpixel map
(hier.py); like the JAX package's they pass no Gumbel key, so
cfg.gumbel_scale changes nothing there."""

from __future__ import annotations

from typing import Callable, Dict

from mulactseg_tpu_torch.losses.hier import hier_group_multi_label_ce
from mulactseg_tpu_torch.losses.partial import (
    group_multi_label_ce,
    multi_choice_ce,
)
from mulactseg_tpu_torch.losses.standard import (
    cross_entropy,
    focal_loss,
    rcce_asym,
)


def _ce(cfg):
    return lambda lg, b: cross_entropy(lg, b["labels"], temp=cfg.ce_temp,
                                       ignore_index=cfg.ignore_idx)


def _focal(cfg):
    return lambda lg, b: focal_loss(lg, b["labels"],
                                    ignore_index=cfg.ignore_idx)


def _mc(cfg):
    return lambda lg, b: multi_choice_ce(
        lg, b["target"], b["spx"], b["spmask"], temp=cfg.multi_ce_temp)


def _group(cfg):
    return lambda lg, b: group_multi_label_ce(
        lg, b["target"], b["spx"], b["spmask"], nseg=cfg.nseg,
        temp=cfg.group_ce_temp)


def _hier(cfg):
    return lambda lg, b: hier_group_multi_label_ce(
        lg, b["target"], b["spx"], b["spx_small"], b["spmask"],
        nseg=cfg.nseg, small_nseg=cfg.small_nseg, temp=cfg.group_ce_temp,
        only_single=cfg.group_only_single)


def _joint_multi(cfg):
    g, m = _group(cfg), _mc(cfg)
    return lambda lg, b: (g(lg, b), m(lg, b))


def _joint_hier(cfg):
    h, m = _hier(cfg), _mc(cfg)
    return lambda lg, b: (h(lg, b), m(lg, b))


def _rc_asym(cfg):
    """target_maps (B, C + 1, H, W) dense candidate maps, logits_weak the
    weak view's logits."""
    return lambda lg, b: rcce_asym(lg, b["logits_weak"], b["target_maps"],
                                   temp=cfg.multi_ce_temp)


LOSS_TYPES: Dict[str, Callable] = {
    "cross_entropy": _ce,
    "focal_loss": _focal,
    "multi_choice_ce": _mc,
    "group_multi_label_ce": _group,
    "hierarchy_group_multi_label_ce": _hier,
    "joint_multi_loss": _joint_multi,
    "joint_hierarchy_multi_loss": _joint_hier,
    "rc_asym_ce": _rc_asym,
}


def get_loss_type(cfg):
    if cfg.loss_type not in LOSS_TYPES:
        raise KeyError(f"unknown loss_type {cfg.loss_type!r}; "
                       f"have {sorted(LOSS_TYPES)}")
    return LOSS_TYPES[cfg.loss_type](cfg)
