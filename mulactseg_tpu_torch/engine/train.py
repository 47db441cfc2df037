"""Training and eval steps: the port of mulactseg_tpu/engine/train.py.

The criteria are the JAX package's CRITERIA (train.py:491-543) but the
eleven of ROADMAP.md queue A, item 14b (PENDING), in the same order: the
fused lossdecomp of stage 1 (active_joint_multi_predignore_lossdecomp on
Cityscapes' C+1-class model, active_joint_multi_lossdecomp on VOC's
21-class one; the unfused lossdecomp for a batch without target bits),
the joint group + MC criteria and their ablations, pwce, top1plbl,
wgroup, sequence, and the plain temperature CE of stage 2
(active_predignore; active on VOC). NaN guards mirror
trainer/active_joint_multi.py:17-29 (zero_if_nan per component).

One eager step per call: forward (BN in train mode, conv stack under
bfloat16 autocast on the card as cfg.dtype="bfloat16" asks), the criterion
on the float32 NCHW logits, backward, the optimizer with its per-group
schedule. The step moves to the device only the images and the keys its
criterion reads. The JAX package's K-step lax.scan only hides TPU
dispatch latency and has no counterpart here.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from mulactseg_tpu_torch.data.constants import IMAGENET_MEAN, IMAGENET_STD
from mulactseg_tpu_torch.device import resolve_device
from mulactseg_tpu_torch.engine.state import make_optimizer, set_lr
from mulactseg_tpu_torch.losses.fused import lossdecomp_fused
from mulactseg_tpu_torch.losses.online import (
    prototype_weight_targets,
    prototype_weighted_ce,
)
from mulactseg_tpu_torch.losses.partial import (
    exclusive_ce,
    group_multi_label_ce,
    lossdecomp,
    max_multi_choice_ce,
    multi_choice_ce,
    multi_choice_ce_only_dominant,
    multi_choice_ce_scale,
    multi_choice_ent,
    onehot_ce_multihot_choice,
    onehot_ce_multihot_rc,
    onehot_ce_multihot_topone,
    plbl_onehot_ce_multihot_choice,
    rand_multi_choice_ce,
    rc_multi_choice_ce,
    top_one_plbl_loss,
    weighted_group_multi_label_ce,
)
from mulactseg_tpu_torch.losses.standard import cross_entropy
from mulactseg_tpu_torch.models.layers import Dropout, bn_frozen

_REGION = ("target", "spx", "spmask")


def _zero_if_nan(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _args(logits, batch):
    return (logits, batch["target"], batch["spx"], batch["spmask"])


def _joint_loss(cfg, slice_last):
    """coeff * MC + coeff_gm * group (train.py:49-61)."""
    def fn(logits, batch):
        group = group_multi_label_ce(*_args(logits, batch), nseg=cfg.nseg,
                                     temp=cfg.group_ce_temp,
                                     slice_last=slice_last)
        pos = multi_choice_ce(*_args(logits, batch), temp=cfg.multi_ce_temp,
                              slice_last=slice_last)
        group, pos = _zero_if_nan(group), _zero_if_nan(pos)
        total = cfg.coeff * pos + cfg.coeff_gm * group
        return total, {"train_loss": total, "pos_loss": pos,
                       "group_loss": group}
    fn.keys = _REGION
    return fn


def _lossdecomp_loss(cfg):
    """The fused path over loader-packed target bits; without them (more
    than 31 classes) the unfused lossdecomp (train.py:64-89)."""
    def fn(logits, batch):
        if "target_bits" in batch:
            total, aux = lossdecomp_fused(
                logits, batch["target_bits"], batch["target"], batch["spx"],
                nseg=cfg.nseg, coeff=cfg.coeff, coeff_mc=cfg.coeff_mc,
                coeff_gm=cfg.coeff_gm, multi_ce_temp=cfg.multi_ce_temp,
                group_ce_temp=cfg.group_ce_temp)
        else:
            total, aux = lossdecomp(
                *_args(logits, batch), nseg=cfg.nseg, coeff=cfg.coeff,
                coeff_mc=cfg.coeff_mc, coeff_gm=cfg.coeff_gm,
                multi_ce_temp=cfg.multi_ce_temp,
                group_ce_temp=cfg.group_ce_temp)
        return _zero_if_nan(total), aux
    fn.keys = ("target_bits",) + _REGION
    return fn


def _mclossablation2_loss(cfg):
    """group (multi-hot pixels only) + CE on one-hot pixels
    (train.py:92-105)."""
    def fn(logits, batch):
        group = group_multi_label_ce(*_args(logits, batch), nseg=cfg.nseg,
                                     temp=cfg.group_ce_temp,
                                     slice_last=False, only_multi=True)
        ce, _ = onehot_ce_multihot_choice(*_args(logits, batch),
                                          temp=cfg.multi_ce_temp)
        total = cfg.coeff * ce + cfg.coeff_gm * group
        return _zero_if_nan(total), {"train_loss": total, "ce_loss": ce,
                                     "group_loss": group}
    fn.keys = _REGION
    return fn


def _ce_loss(cfg):
    """Stage 2: CE on the pseudo-label maps (train.py:108-113)."""
    def fn(logits, batch):
        loss = cross_entropy(logits, batch["labels"], temp=cfg.ce_temp,
                             ignore_index=cfg.ignore_idx)
        return loss, {"train_loss": loss}
    fn.keys = ("labels",)
    return fn


def _precise_loss(cfg, with_group=True):
    """Oracle trainers: CE on the batch's labels plus the group or the MC
    term (train.py:116-135)."""
    def fn(logits, batch):
        ce = _zero_if_nan(cross_entropy(logits, batch["labels"],
                                        temp=cfg.ce_temp,
                                        ignore_index=cfg.ignore_idx))
        if with_group:
            other = group_multi_label_ce(*_args(logits, batch),
                                         nseg=cfg.nseg,
                                         temp=cfg.group_ce_temp,
                                         slice_last=False)
        else:
            other = multi_choice_ce(*_args(logits, batch),
                                    temp=cfg.multi_ce_temp,
                                    slice_last=False)
        total = ce + other
        return total, {"train_loss": total, "ce_loss": ce,
                       ("group_loss" if with_group else "pos_loss"): other}
    fn.keys = ("labels",) + _REGION
    return fn


def _multient_loss(cfg):
    """coeff * MC + group + entcoeff * entropy within the candidates
    (train.py:138-153)."""
    def fn(logits, batch):
        args = _args(logits, batch)
        group = group_multi_label_ce(*args, nseg=cfg.nseg,
                                     temp=cfg.group_ce_temp,
                                     slice_last=False)
        pos = multi_choice_ce(*args, temp=cfg.multi_ce_temp,
                              slice_last=False)
        ent = multi_choice_ent(*args, temp=cfg.multi_ce_temp,
                               slice_last=False)
        total = cfg.coeff * pos + group + cfg.entcoeff * _zero_if_nan(ent)
        return total, {"train_loss": total, "pos_loss": pos,
                       "group_loss": group, "ent_loss": ent}
    fn.keys = _REGION
    return fn


def _exclusivece_loss(cfg):
    """coeff * exclusive CE + coeff_gm * group (train.py:156-166)."""
    def fn(logits, batch):
        args = _args(logits, batch)
        group = group_multi_label_ce(*args, nseg=cfg.nseg,
                                     temp=cfg.group_ce_temp,
                                     slice_last=False)
        pos = exclusive_ce(*args)
        total = cfg.coeff * pos + cfg.coeff_gm * group
        return _zero_if_nan(total), {"train_loss": total, "pos_loss": pos,
                                     "group_loss": group}
    fn.keys = _REGION
    return fn


def _lossdecomp_variant(mc_fn):
    """lossdecomp with another multi-hot term (train.py:169-181)."""
    def build(cfg):
        def fn(logits, batch):
            args = _args(logits, batch)
            group = group_multi_label_ce(*args, nseg=cfg.nseg,
                                         temp=cfg.group_ce_temp,
                                         slice_last=False, only_multi=True)
            ce, mc = mc_fn(*args, temp=cfg.multi_ce_temp)
            total = cfg.coeff * ce + cfg.coeff_mc * mc + cfg.coeff_gm * group
            return _zero_if_nan(total), {"train_loss": total, "ce_loss": ce,
                                         "mc_loss": mc, "group_loss": group}
        fn.keys = _REGION
        return fn
    return build


def _pos_plus_group(cfg, pos_fn):
    """coeff * <MC variant> + coeff_gm * group (train.py:184-196)."""
    def fn(logits, batch):
        args = _args(logits, batch)
        group = group_multi_label_ce(*args, nseg=cfg.nseg,
                                     temp=cfg.group_ce_temp,
                                     slice_last=False)
        pos = pos_fn(*args, temp=cfg.multi_ce_temp)
        total = cfg.coeff * pos + cfg.coeff_gm * group
        return _zero_if_nan(total), {"train_loss": total, "pos_loss": pos,
                                     "group_loss": group}
    fn.keys = _REGION
    return fn


def _ramp(cfg, frac):
    """The sigmoid ramp of step / total under --dorampup, else 1.0
    (train.py:213-216)."""
    if frac > 1.0 or not cfg.dorampup:
        return 1.0
    return (2.0 / (1.0 + math.exp(-frac / cfg.lamparam)) - 1.0) * cfg.lamscale


def _top1plbl_loss(cfg):
    """coeff * MC + group + ramp * TopOnePlbl (train.py:199-221)."""
    def fn(logits, batch, extra):
        args = _args(logits, batch)
        group = group_multi_label_ce(*args, nseg=cfg.nseg,
                                     temp=cfg.group_ce_temp,
                                     slice_last=False)
        pos = multi_choice_ce(*args, temp=cfg.multi_ce_temp,
                              slice_last=False)
        top1 = top_one_plbl_loss(
            logits, extra["plbl_logits"], batch["target"], batch["spx"],
            batch["spmask"], temp=1.0, within_filtering=cfg.within_filtering,
            threshold=cfg.plbl_th)
        total = cfg.coeff * pos + group + _ramp(cfg, extra["frac"]) * top1
        return _zero_if_nan(total), {"train_loss": total, "pos_loss": pos,
                                     "group_loss": group, "top1_loss": top1}
    fn.keys = _REGION
    fn.needs_feat = True
    return fn


def _pwce_loss(cfg):
    """One prototype-weighted CE, the candidate weights from the eval-mode
    forward's features (train.py:224-261). --simw_temp_schedule pins the
    similarity temperature to 1000 for the first 20k steps."""
    def fn(logits, batch, extra):
        feat, plbl_logits = extra["feat"], extra["plbl_logits"]
        B, C = plbl_logits.shape[:2]
        probs = torch.softmax(plbl_logits.float().reshape(B, C, -1)
                              / cfg.group_ce_temp, dim=1)
        simw_temp = cfg.simw_temp
        if cfg.simw_temp_schedule and \
                extra["frac"] * float(cfg.finetune_itrs) < 20000.0:
            simw_temp = 1000.0
        w = torch.stack([prototype_weight_targets(
            feat[b].reshape(feat.shape[1], -1).t(), probs[b].t(),
            batch["target"][b], batch["spx"][b], batch["spmask"][b],
            nseg=cfg.nseg, simw_temp=simw_temp) for b in range(B)])
        total = prototype_weighted_ce(logits, w, batch["spmask"],
                                      temp=cfg.group_ce_temp)
        return _zero_if_nan(total), {"train_loss": total}
    fn.keys = _REGION
    fn.needs_feat = True
    return fn


def _wgroup_loss(cfg):
    """coeff * MC + coeff_gm * group weighted by the eval-mode forward's
    segment max (train.py:264-279)."""
    def fn(logits, batch, extra):
        group = weighted_group_multi_label_ce(
            logits, extra["plbl_logits"], batch["target"], batch["spx"],
            batch["spmask"], nseg=cfg.nseg, temp=cfg.group_ce_temp)
        pos = multi_choice_ce(*_args(logits, batch), temp=cfg.multi_ce_temp,
                              slice_last=False)
        total = cfg.coeff * pos + cfg.coeff_gm * group
        return _zero_if_nan(total), {"train_loss": total, "pos_loss": pos,
                                     "group_loss": group}
    fn.keys = _REGION
    fn.needs_feat = True
    return fn


def _ablation_loss(cfg):
    """--loss_type switch over the MC term, with the sliced group term
    (train.py:429-462): rc_multi_ce, max_multi_ce, or rand_multi_ce, which
    samples from extra['generator']."""
    def fn(logits, batch, extra=None):
        args = _args(logits, batch)
        if cfg.loss_type == "rc_multi_ce":
            pos = rc_multi_choice_ce(*args, temp=cfg.multi_ce_temp)
        elif cfg.loss_type == "max_multi_ce":
            pos = max_multi_choice_ce(*args, temp=cfg.multi_ce_temp)
        elif cfg.loss_type == "rand_multi_ce":
            pos = rand_multi_choice_ce(*args, extra["generator"],
                                       temp=cfg.multi_ce_temp)
        else:
            raise NotImplementedError(cfg.loss_type)
        group = group_multi_label_ce(*args, nseg=cfg.nseg,
                                     temp=cfg.group_ce_temp, slice_last=True)
        pos, group = _zero_if_nan(pos), _zero_if_nan(group)
        total = cfg.coeff * pos + group
        return total, {"train_loss": total, "pos_loss": pos,
                       "group_loss": group}
    fn.keys = _REGION
    fn.needs_rng = cfg.loss_type == "rand_multi_ce"
    return fn


def _sequence_loss(cfg):
    """group + coeff * the pseudo-label-disambiguated MC, whose CE and MC
    buckets share one normaliser (train.py:465-488). batch['labels'] are
    the previous round's pseudo-label maps."""
    def fn(logits, batch):
        ce_sum, ce_num, mc_sum, mc_num = plbl_onehot_ce_multihot_choice(
            *_args(logits, batch), batch["labels"], temp=cfg.multi_ce_temp,
            ignore_idx=cfg.ignore_idx)
        pos = (ce_sum + mc_sum) / (ce_num + mc_num).clamp(min=1)
        group = group_multi_label_ce(*_args(logits, batch), nseg=cfg.nseg,
                                     temp=cfg.group_ce_temp,
                                     slice_last=False)
        pos, group = _zero_if_nan(pos), _zero_if_nan(group)
        total = cfg.coeff * pos + group
        return total, {"train_loss": total, "pos_loss": pos,
                       "group_loss": group}
    fn.keys = ("labels",) + _REGION
    return fn


CRITERIA: Dict[str, Callable] = {
    "active_joint_multi_predignore_lossdecomp": _lossdecomp_loss,
    "active_joint_multi_lossdecomp": _lossdecomp_loss,
    "active_joint_multi_predignore": lambda cfg: _joint_loss(cfg, False),
    "active_joint_multi": lambda cfg: _joint_loss(cfg, True),
    "active_joint_multi_predignore_mclossablation2": _mclossablation2_loss,
    "active_predignore": _ce_loss,
    "active": _ce_loss,
    "active_joint_multi_predignore_precise": lambda cfg: _precise_loss(
        cfg, with_group=True),
    "active_joint_multi_predignore_multice_precise": lambda cfg:
        _precise_loss(cfg, with_group=False),
    "active_joint_multi_predignore_multient": _multient_loss,
    "active_joint_multi_predignore_exclusivece": _exclusivece_loss,
    "active_joint_multi_lossdecomp_rc": _lossdecomp_variant(
        onehot_ce_multihot_rc),
    "active_joint_multi_lossdecomp_topone": _lossdecomp_variant(
        onehot_ce_multihot_topone),
    "active_pwce_multi_predignore": _pwce_loss,
    "active_joint_multi_predignore_top1plbl": _top1plbl_loss,
    "active_joint_multi_predignore_mclossablation": lambda cfg:
        _pos_plus_group(cfg, multi_choice_ce_only_dominant),
    "active_joint_multi_predignore_lscale": lambda cfg:
        _pos_plus_group(cfg, multi_choice_ce_scale),
    "active_joint_multi_predignore_wgroup": _wgroup_loss,
    "active_joint_multi_ablation": _ablation_loss,
    "active_joint_multi_predignore_sequence": _sequence_loss,
    # the reference ships this trainer as an empty file; the JAX package
    # registers the predignore criterion under its name
    "active_joint_multi_predignore_logprecision": lambda cfg: _joint_loss(
        cfg, False),
}
# the JAX package's other criteria: ROADMAP.md queue A, item 14b (they
# need the online pseudo labels, the hierarchy and mixed-scale losses,
# or the sliding forward)
PENDING = (
    "active_slide",
    "active_onlineplbl_multi_predignore",
    "active_onlinewplbl_multi_predignore",
    "active_onlinesimwplbl_multi_predignore",
    "active_onlinewplblonly_multi_predignore",
    "active_onlineplbl_multi_predignore_domc",
    "active_onlinesimwplbl_multi_predignore_domc",
    "active_joint_hier_multi",
    "active_joint_hier_multi_async",
    "active_joint_hier_multi_async_weight",
    "active_joint_multi_predignore_mseg",
)


def get_criterion(cfg):
    if cfg.method in PENDING:
        raise NotImplementedError(
            f"method {cfg.method!r} is not ported yet: ROADMAP.md queue A, "
            "item 14b")
    if cfg.method not in CRITERIA:
        raise KeyError(
            f"method {cfg.method!r} has no registered criterion; "
            f"available: {sorted(CRITERIA)}")
    return CRITERIA[cfg.method](cfg)


def _device_normalize(x):
    """uint8 NCHW images -> ImageNet-normalised float32, same op order as
    the JAX package's _device_normalize (train.py:554-563)."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)[None, :, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=x.device)[None, :, None, None]
    return (x.float() / 255.0 - mean) / std


def make_train_step(model: torch.nn.Module, cfg, device="cuda",
                    generator: Optional[torch.Generator] = None,
                    optimizer: Optional[torch.optim.Optimizer] = None):
    """Returns step(batch) -> aux dict of detached loss tensors (no host
    sync). batch: 'images' (B, 3, H, W) float32 or uint8 and the
    criterion's keys (criterion.keys): 'target' (B, nseg, C) float32,
    'spx' (B, H, W) int and 'spmask' (B, H, W) bool for the region
    criteria, with 'target_bits' (B, H, W) int32 for the fused lossdecomp;
    'labels' (B, H, W) int for CE, the precise and the sequence criteria.
    Other keys stay on the host. `optimizer` defaults to
    make_optimizer(model, cfg). The step count (step.step, which sets the
    schedule; a caller restoring a checkpoint sets it), the optimizer
    (step.optimizer) and the dropout generator live on the returned
    function.

    A criterion with needs_feat gets an eval-mode forward of the same
    images with return_feat, before the train forward (so BN reads the
    running statistics the step starts from, as the JAX package's
    pre-step batch_stats), under no_grad and the step's autocast: BN
    statistics stay as they are and dropout draws nothing. It hands
    extra = {feat, plbl_logits, frac = step / cfg.finetune_itrs}, the
    step counted before the update (train.py:601-611). A criterion with
    needs_rng (rand_multi_ce) draws from a generator of its own on the
    device, apart from the dropout stream, seeded with cfg.seed + 1 (the
    round loop seeds dropout with cfg.seed)."""
    dev = resolve_device(device)
    criterion = get_criterion(cfg)
    needs_feat = getattr(criterion, "needs_feat", False)
    needs_rng = getattr(criterion, "needs_rng", False)
    opt = optimizer if optimizer is not None else make_optimizer(model, cfg)
    keys = ("images",) + criterion.keys
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    autocast = dev.type == "cuda" and cfg.dtype == "bfloat16"
    sampler = (torch.Generator(dev).manual_seed(cfg.seed + 1) if needs_rng
               else None)

    def step(batch):
        batch = {k: torch.as_tensor(batch[k]).to(dev, non_blocking=True)
                 for k in keys if k in batch}
        images = batch["images"]
        if images.dtype == torch.uint8:
            images = _device_normalize(images)
        extra = None
        if needs_feat:
            model.eval()
            with torch.no_grad(), torch.autocast(
                    dev.type, dtype=torch.bfloat16, enabled=autocast):
                feat, plbl_logits = model(images, return_feat=True)
            extra = {"feat": feat, "plbl_logits": plbl_logits,
                     "frac": step.step / float(cfg.finetune_itrs)}
        elif needs_rng:
            extra = {"generator": sampler}
        model.train()
        set_lr(opt, cfg, step.step)
        with bn_frozen(model, cfg.freeze_bn), torch.autocast(
                dev.type, dtype=torch.bfloat16, enabled=autocast):
            logits = model(images)
        total, aux = (criterion(logits, batch) if extra is None
                      else criterion(logits, batch, extra))
        opt.zero_grad(set_to_none=True)
        total.backward()
        opt.step()
        step.step += 1
        return {k: v.detach() for k, v in aux.items()}

    step.step = 0
    step.optimizer = opt
    return step


def make_eval_step(model: torch.nn.Module, cfg, device="cuda"):
    """Returns predict(images) -> eval-mode float32 NCHW logits on the
    device (train.py:677-684): images (B, 3, H, W) uint8 or normalised
    float32, the forward under bfloat16 autocast on the card when
    cfg.dtype == "bfloat16"."""
    from mulactseg_tpu_torch.engine.evaluate import eval_forward

    dev = resolve_device(device)
    autocast = dev.type == "cuda" and cfg.dtype == "bfloat16"

    def predict(images):
        return eval_forward(model, images, dev, autocast)

    return predict
