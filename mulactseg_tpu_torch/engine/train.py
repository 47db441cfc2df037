"""Training and eval steps: the port of mulactseg_tpu/engine/train.py.

The criteria are the JAX package's CRITERIA (train.py:491-543), all 32,
in the same order: the fused lossdecomp of stage 1
(active_joint_multi_predignore_lossdecomp on Cityscapes' C+1-class model,
active_joint_multi_lossdecomp on VOC's 21-class one; the unfused
lossdecomp for a batch without target bits), the joint group + MC
criteria and their ablations, the online pseudo-label family, pwce,
top1plbl, wgroup, the two-scale hierarchy family, the mixed-scale mseg
criterion, sequence, and the plain temperature CE of stage 2
(active_predignore; active on VOC; active_slide, whose sliding window
is its validation's, cfg.sliding_eval). NaN guards mirror
trainer/active_joint_multi.py:17-29 (zero_if_nan per component).

One step per call: forward (BN in train mode, conv stack under
bfloat16 autocast on the card as cfg.dtype="bfloat16" asks), the criterion
on the float32 NCHW logits, backward, the optimizer with its per-group
schedule. The step moves to the device only the images and the keys its
criterion reads. On one card the step is captured once into a CUDA graph
and replayed on later calls, one host call for the ~4,600 launches of
the same kernels in the same order (make_train_step says when); this is
the card's counterpart of the JAX package's K-step lax.scan, which only
hides TPU dispatch latency. Everywhere else each call runs eagerly.

Under data parallelism (parallel/mesh.py) each rank steps on its rows of
the global batch: the weights are broadcast from rank 0 when the step is
made, BN and every criterion's normalisers see the global batch
(losses/), the gradients are summed over the ranks before the optimizer,
and the NaN guards and the logged losses read the global loss. The
eval-mode forwards of the needs_feat and needs_weak_forward criteria
run on each rank's rows alone (BN in eval mode needs no collective).
"""

from __future__ import annotations

import logging
from collections import Counter
from typing import Callable, Dict, Optional

import torch

from mulactseg_tpu_torch.data.constants import IMAGENET_MEAN, IMAGENET_STD
from mulactseg_tpu_torch.device import bf16_autocast, resolve_device
from mulactseg_tpu_torch.engine.state import device_lrs, make_optimizer, set_lr
from mulactseg_tpu_torch.losses.fused import lossdecomp_fused
from mulactseg_tpu_torch.losses.hier import (
    async_hier_group_multi_label_ce,
    aug_hier_group_multi_label_ce,
    hier_group_multi_label_ce,
)
from mulactseg_tpu_torch.losses.mseg import mseg_joint_loss
from mulactseg_tpu_torch.losses.online import (
    local_proto_ce,
    local_proto_plbl,
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
from mulactseg_tpu_torch.ops import _build
from mulactseg_tpu_torch.parallel import mesh
from mulactseg_tpu_torch.utils.schedule import ramp_up
from mulactseg_tpu_torch.utils.spans import span

log = logging.getLogger("mulactseg_tpu_torch")

_REGION = ("target", "spx", "spmask")


def _zero_if_nan_global(x):
    """x, or 0 where it is not finite (the reference's zero_if_nan),
    decided on x summed over the ranks: under data parallelism every rank
    keeps or zeroes its share of the global loss together, as one rank
    holding the whole batch would."""
    return torch.where(mesh.global_isfinite(x), x, torch.zeros_like(x))


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
        group, pos = _zero_if_nan_global(group), _zero_if_nan_global(pos)
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
        return _zero_if_nan_global(total), aux
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
        return _zero_if_nan_global(total), {
            "train_loss": total, "ce_loss": ce, "group_loss": group}
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
        ce = _zero_if_nan_global(cross_entropy(
            logits, batch["labels"], temp=cfg.ce_temp,
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
        total = (cfg.coeff * pos + group
                 + cfg.entcoeff * _zero_if_nan_global(ent))
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
        return _zero_if_nan_global(total), {
            "train_loss": total, "pos_loss": pos, "group_loss": group}
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
            return _zero_if_nan_global(total), {
                "train_loss": total, "ce_loss": ce, "mc_loss": mc,
                "group_loss": group}
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
        return _zero_if_nan_global(total), {
            "train_loss": total, "pos_loss": pos, "group_loss": group}
    fn.keys = _REGION
    return fn


def _ramp(cfg, frac):
    """The sigmoid ramp of step / total under --dorampup, else 1.0
    (train.py:213-216, :386-389)."""
    return ramp_up(frac, cfg.lamparam, cfg.lamscale, cfg.dorampup)


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
        return _zero_if_nan_global(total), {
            "train_loss": total, "pos_loss": pos, "group_loss": group,
            "top1_loss": top1}
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
        return _zero_if_nan_global(total), {"train_loss": total}
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
        return _zero_if_nan_global(total), {
            "train_loss": total, "pos_loss": pos, "group_loss": group}
    fn.keys = _REGION
    fn.needs_feat = True
    return fn


def _hier_joint_loss(cfg, async_views=False, weight_reduce=None):
    """coeff * MC + coeff_gm * the hierarchy group term (train.py:
    282-321): with async_views the pairs come from the weak view, whose
    eval-mode logits the step adds to the batch (needs_weak_forward);
    --nocropsp takes the border-stripping aug variant. The JAX criterion
    passes no Gumbel key, so cfg.gumbel_scale changes nothing
    (ROADMAP.md, open questions for the reference's owners)."""
    hier_fn = (aug_hier_group_multi_label_ce if cfg.nocropsp
               else hier_group_multi_label_ce)

    def fn(logits, batch):
        pos = multi_choice_ce(*_args(logits, batch), temp=cfg.multi_ce_temp)
        if async_views:
            hier = async_hier_group_multi_label_ce(
                logits, batch["logits_weak"], batch["target"],
                batch["spx_weak"], batch["spx_small"],
                batch["spx_small_weak"], batch["spmask"],
                batch["spmask_weak"], nseg=cfg.nseg,
                small_nseg=cfg.small_nseg, temp=cfg.group_ce_temp,
                weight_reduce=weight_reduce)
        else:
            hier = hier_fn(
                logits, batch["target"], batch["spx"], batch["spx_small"],
                batch["spmask"], nseg=cfg.nseg, small_nseg=cfg.small_nseg,
                temp=cfg.group_ce_temp, only_single=cfg.group_only_single)
        total = cfg.coeff * pos + cfg.coeff_gm * hier
        return _zero_if_nan_global(total), {
            "train_loss": total, "pos_loss": pos, "group_loss": hier}
    fn.keys = _REGION + ("spx_small",)
    if async_views:
        fn.keys += ("images_weak", "spx_weak", "spmask_weak",
                    "spx_small_weak")
        fn.needs_weak_forward = True
    return fn


def _online_plbl_loss(cfg, weighted=False, only_plbl=False, do_mc=False,
                      weight_source="sim"):
    """The online pseudo-label family (train.py:324-402): lam * the CE
    against each step's online pseudo labels (losses/online.
    local_proto_plbl on the eval-mode forward's features and softmax at
    group_ce_temp) + coeff * MC, unless only_plbl, + coeff_gm * the group
    term of the multi-hot pixels, with do_mc. lam is the ramp under
    --dorampup, else 1.0. weighted scales each pixel's CE by a detached
    weight: 'sim', the cosine similarity to its prototype, or 'prob', the
    eval softmax at its pseudo label (1.0 at the prototypes' own pixels
    under --weight_wo_proto). --th_wplbl keeps only the pixels whose
    weight exceeds it, unweighted."""
    def fn(logits, batch, extra):
        feat, plbl_logits = extra["feat"], extra["plbl_logits"]
        B, C = plbl_logits.shape[:2]
        probs = torch.softmax(plbl_logits.float().reshape(B, C, -1)
                              / cfg.group_ce_temp, dim=1)
        out = [local_proto_plbl(
            feat[b].reshape(feat.shape[1], -1).t(), probs[b].t(),
            batch["target"][b], batch["spx"][b], batch["spmask"][b],
            nseg=cfg.nseg) for b in range(B)]
        plbl, sim, is_src = (torch.stack(t) for t in zip(*out))  # (B, P)
        w = None
        if weighted:
            if weight_source == "prob":
                w = probs.gather(1, plbl.clamp(0, C - 1)[:, None])[:, 0]
                w = torch.where(plbl != cfg.ignore_idx, w, 0.0)
                if cfg.weight_wo_proto:
                    w = torch.where(is_src, 1.0, w)
            else:
                w = sim
        if weighted and cfg.th_wplbl is not None:
            # a hard gate: pixels at weight <= th leave the sum and the
            # mean's count
            plbl = torch.where(w > cfg.th_wplbl, plbl, cfg.ignore_idx)
            w = None
        shape = (B,) + logits.shape[2:]
        proto = local_proto_ce(logits, plbl.reshape(shape),
                               temp=cfg.group_ce_temp,
                               weights=None if w is None else w.reshape(shape))
        terms = {"local_proto_loss": proto}
        total = _ramp(cfg, extra["frac"]) * proto
        if not only_plbl:
            pos = multi_choice_ce(*_args(logits, batch),
                                  temp=cfg.multi_ce_temp, slice_last=False)
            total = total + cfg.coeff * pos
            terms["pos_loss"] = pos
        if do_mc:
            group = group_multi_label_ce(*_args(logits, batch), nseg=cfg.nseg,
                                         temp=cfg.group_ce_temp,
                                         slice_last=False, only_multi=True)
            total = total + cfg.coeff_gm * group
            terms["group_loss"] = group
        terms["train_loss"] = total
        return _zero_if_nan_global(total), terms
    fn.keys = _REGION
    fn.needs_feat = True
    return fn


def _mseg_loss(cfg):
    """The mixed-superpixel-scale criterion (train.py:407-426): coeff * MC
    + the group term over every level, the group temperature pinned to
    1.0, as the reference hard-codes it whatever --group_ce_temp says."""
    nseg_list = tuple(sorted(int(n) for n in cfg.nseg_list))
    if not nseg_list:
        raise ValueError("method _mseg requires cfg.nseg_list")
    targets = tuple(f"mseg_target_{i}" for i in range(len(nseg_list)))

    def fn(logits, batch):
        total, aux = mseg_joint_loss(
            logits, [batch[k] for k in targets], batch["mseg_spx"],
            batch["mseg_spmask"], nseg_list=nseg_list, coeff=cfg.coeff,
            multi_ce_temp=cfg.multi_ce_temp, group_ce_temp=1.0)
        return _zero_if_nan_global(total), aux
    fn.keys = ("mseg_spx", "mseg_spmask") + targets
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
        pos, group = _zero_if_nan_global(pos), _zero_if_nan_global(group)
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
        pos = (ce_sum + mc_sum) / (ce_num + mc_num).clamp(min=1).to(
            ce_sum.dtype)
        group = group_multi_label_ce(*_args(logits, batch), nseg=cfg.nseg,
                                     temp=cfg.group_ce_temp,
                                     slice_last=False)
        pos, group = _zero_if_nan_global(pos), _zero_if_nan_global(group)
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
    "active_slide": _ce_loss,
    "active_onlineplbl_multi_predignore": _online_plbl_loss,
    "active_onlinewplbl_multi_predignore": lambda cfg: _online_plbl_loss(
        cfg, weighted=True, weight_source="prob"),
    "active_onlinesimwplbl_multi_predignore": lambda cfg: _online_plbl_loss(
        cfg, weighted=True),
    "active_onlinewplblonly_multi_predignore": lambda cfg: _online_plbl_loss(
        cfg, weighted=True, only_plbl=True, weight_source="prob"),
    "active_onlineplbl_multi_predignore_domc": lambda cfg: _online_plbl_loss(
        cfg, do_mc=True),
    "active_onlinesimwplbl_multi_predignore_domc": lambda cfg:
        _online_plbl_loss(cfg, weighted=True, do_mc=True),
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
    "active_joint_hier_multi": lambda cfg: _hier_joint_loss(cfg),
    "active_joint_hier_multi_async": lambda cfg: _hier_joint_loss(
        cfg, async_views=True),
    # --weight_reduce, 'max' by default (the reference's utils/loss.py:238)
    "active_joint_hier_multi_async_weight": lambda cfg: _hier_joint_loss(
        cfg, async_views=True, weight_reduce=cfg.weight_reduce),
    "active_joint_multi_predignore_mseg": _mseg_loss,
    "active_joint_multi_ablation": _ablation_loss,
    "active_joint_multi_predignore_sequence": _sequence_loss,
    # the reference ships this trainer as an empty file; the JAX package
    # registers the predignore criterion under its name
    "active_joint_multi_predignore_logprecision": lambda cfg: _joint_loss(
        cfg, False),
}


def get_criterion(cfg):
    if cfg.method not in CRITERIA:
        raise KeyError(
            f"method {cfg.method!r} has no registered criterion; "
            f"available: {sorted(CRITERIA)}")
    return CRITERIA[cfg.method](cfg)


def _norm_constants(device):
    """The ImageNet mean and std as (1, 3, 1, 1) tensors on `device`."""
    return tuple(torch.as_tensor(v, device=device)[None, :, None, None]
                 for v in (IMAGENET_MEAN, IMAGENET_STD))


def _device_normalize(x, constants=None):
    """uint8 NCHW images -> ImageNet-normalised float32, same op order as
    the JAX package's _device_normalize (train.py:554-563). `constants`:
    _norm_constants(x.device) made beforehand (a CUDA graph's capture
    cannot copy them from the host), else made here."""
    mean, std = constants or _norm_constants(x.device)
    return (x.float() / 255.0 - mean) / std


# criterion flags that keep the step eager: the eval-mode forwards and
# host-side `extra` of needs_feat and needs_weak_forward, the sampler of
# needs_rng
_EAGER_FLAGS = ("needs_feat", "needs_weak_forward", "needs_rng")


def graphable(dev, criterion, opt) -> bool:
    """Whether make_train_step's step may capture and replay a CUDA graph,
    from what it can observe: a CUDA device, no process group, a
    criterion with none of _EAGER_FLAGS, anomaly detection off and every
    optimizer group's LR in a device tensor (engine/state.device_lrs: the
    card's AdamW). The step also holds each batch to the captured
    signature (_signature)."""
    return (dev.type == "cuda" and not mesh.active()
            and not any(getattr(criterion, f, False) for f in _EAGER_FLAGS)
            and not torch.is_anomaly_enabled() and device_lrs(opt))


def _signature(host) -> tuple:
    """(key, shape, dtype) of each tensor of the batch the step reads."""
    return tuple((k, tuple(t.shape), t.dtype) for k, t in host.items())


def _aux_copy(aux):
    """The graph's static losses copied out by one stack, unbound into
    views: each call's values stay the caller's after the next replay."""
    return dict(zip(aux, torch.stack(list(aux.values())).unbind()))


def make_train_step(model: torch.nn.Module, cfg, device="cuda",
                    generator: Optional[torch.Generator] = None,
                    optimizer: Optional[torch.optim.Optimizer] = None):
    """Returns step(batch) -> aux dict of detached loss tensors (no host
    sync). batch: 'images' (B, 3, H, W) float32 or uint8 and the
    criterion's keys (criterion.keys): 'target' (B, nseg, C) float32,
    'spx' (B, H, W) int and 'spmask' (B, H, W) bool for the region
    criteria, with 'target_bits' (B, H, W) int32 for the fused lossdecomp;
    'labels' (B, H, W) int for CE, the precise and the sequence criteria;
    'spx_small' (B, H, W) for the hierarchy criteria, and for the async
    ones 'images_weak' (B, 3, Hw, Ww) float32 or uint8 with 'spx_weak',
    'spmask_weak' and 'spx_small_weak' (B, Hw, Ww); 'mseg_spx',
    'mseg_spmask' (B, S, H, W) and 'mseg_target_<i>' for mseg. Other keys
    stay on the host. `optimizer` defaults to
    make_optimizer(model, cfg). The step count (step.step, which sets the
    schedule; a caller restoring a checkpoint sets it), the optimizer
    (step.optimizer) and the dropout generator live on the returned
    callable.

    A criterion with needs_feat gets an eval-mode forward of the same
    images with return_feat, before the train forward (so BN reads the
    running statistics the step starts from, as the JAX package's
    pre-step batch_stats), under no_grad and the step's autocast: BN
    statistics stay as they are and dropout draws nothing. It hands
    extra = {feat, plbl_logits, frac = step / cfg.finetune_itrs}, the
    step counted before the update (train.py:601-611). A criterion with
    needs_weak_forward (the async hierarchy criteria) gets the eval-mode
    logits of the weak view in batch['logits_weak'], made the same way
    before the train forward (train.py:595-600). A criterion with
    needs_rng (rand_multi_ce) draws from a generator of its own on the
    device, apart from the dropout stream, seeded with cfg.seed + 1 (the
    round loop seeds dropout with cfg.seed).

    The CUDA graph. Where graphable() holds, a call whose batch has the
    key, shape and dtype signature of the eager step before it (or of a
    graph dropped since) captures the step (normalisation, forward,
    criterion, zero_grad, backward, opt.step) into one
    torch.cuda.CUDAGraph, inputs read from static device buffers and the
    dropout generator registered with the graph, and replays it once; later calls with that signature copy the batch
    into the buffers, fill the LRs of step.step (set_lr) and replay. A
    replay draws the dropout masks an eager step would draw from the same
    generator state, and returns its losses as new tensors. Any other
    call runs eagerly and leaves the graph in place; a replaced optimizer
    state or param_groups object drops it (it read their tensors), and a
    capture that fails leaves every later call eager. ops/_build.LAUNCHES
    counts what reaches the device: a capture adds nothing, each replay
    the captured step's launches.

    Each call is a span train.step (utils/spans.py) holding train.h2d
    (the copies to the device) and one of train.eager (the eager body:
    train.forward, the train-mode forward; train.loss; train.backward;
    train.optimizer, its step), train.replay, or train.capture (the
    capture, which runs the body's spans once more without device work)
    and then train.replay."""
    return _TrainStep(model, cfg, resolve_device(device), generator,
                      optimizer)


class _TrainStep:
    """make_train_step's step: a class and not a closure, so that nothing
    refers back to it and dropping it frees its CUDA graph's memory at
    once, not at the next garbage collection."""

    def __init__(self, model, cfg, dev, generator, optimizer):
        if dev.type == "cuda":
            # one nvcc for each kernel library not built yet, all at once
            _build.build_all(_build.SOURCES)
        # an unknown method raises here on every rank, before any
        # collective
        self.criterion = criterion = get_criterion(cfg)
        mesh.broadcast_state(model)
        self.model, self.cfg, self.dev, self.generator = (model, cfg, dev,
                                                          generator)
        self.needs_feat = getattr(criterion, "needs_feat", False)
        self.needs_rng = getattr(criterion, "needs_rng", False)
        self.needs_weak = getattr(criterion, "needs_weak_forward", False)
        self.optimizer = opt = (optimizer if optimizer is not None
                                else make_optimizer(model, cfg))
        self.keys = ("images",) + criterion.keys
        for m in model.modules():
            if isinstance(m, Dropout):
                m.generator = generator
        self.autocast = bf16_autocast(dev, cfg)
        self.sampler = (torch.Generator(dev).manual_seed(cfg.seed + 1)
                        if self.needs_rng else None)
        self.norm = _norm_constants(dev)
        self.step = 0
        # the captured step: graph, static inputs and losses, signature
        # (kept when the graph is dropped), launches a replay adds, the
        # optimizer objects it read; `warm` the signature of the last
        # eager step and `stateful` the parameters with optimizer state
        # after it; `off` once a capture failed
        self.graph = self.sig = self.inputs = self.aux = None
        self.launches, self.opt_objs = Counter(), (opt.state,
                                                   opt.param_groups)
        self.warm, self.stateful, self.off = None, (), False

    def __call__(self, batch):
        opt = self.optimizer
        with span("train.step"):
            host = {k: torch.as_tensor(batch[k]) for k in self.keys
                    if k in batch}
            sig = (_signature(host) if not self.off
                   and graphable(self.dev, self.criterion, opt) else None)
            if self.graph is not None and (
                    self.opt_objs[0] is not opt.state
                    or self.opt_objs[1] is not opt.param_groups):
                # it read the replaced objects' tensors
                self.graph = self.inputs = self.aux = None
            out = None
            if sig is not None and self.graph is not None \
                    and sig == self.sig:
                out = self._replay(host)
            elif sig is not None and self.graph is None \
                    and sig in (self.warm, self.sig) \
                    and all(p in opt.state for p in self.stateful):
                out = self._capture(host, sig)
            if out is None:
                out = self._eager(host)
                self.warm, self.stateful = sig, list(opt.state)
            self.step += 1
            return out

    def _body(self, batch, cache=None):
        """One step on the device tensors of `batch`: forward, criterion,
        backward, update; the criterion's aux losses."""
        model, cfg, dev, opt = self.model, self.cfg, self.dev, self.optimizer
        images = batch["images"]
        if images.dtype == torch.uint8:
            images = _device_normalize(images, self.norm)
        extra = None
        if self.needs_weak:
            weak = batch["images_weak"]
            if weak.dtype == torch.uint8:
                weak = _device_normalize(weak, self.norm)
            model.eval()
            with torch.no_grad(), torch.autocast(
                    dev.type, dtype=torch.bfloat16, enabled=self.autocast):
                batch["logits_weak"] = model(weak).float()
        if self.needs_feat:
            model.eval()
            with torch.no_grad(), torch.autocast(
                    dev.type, dtype=torch.bfloat16, enabled=self.autocast):
                feat, plbl_logits = model(images, return_feat=True)
            extra = {"feat": feat, "plbl_logits": plbl_logits,
                     "frac": self.step / float(cfg.finetune_itrs)}
        elif self.needs_rng:
            extra = {"generator": self.sampler}
        model.train()
        with span("train.forward"), bn_frozen(model, cfg.freeze_bn), \
                torch.autocast(dev.type, dtype=torch.bfloat16,
                               enabled=self.autocast, cache_enabled=cache):
            logits = model(images)
        with span("train.loss"):
            total, aux = (self.criterion(logits, batch) if extra is None
                          else self.criterion(logits, batch, extra))
        opt.zero_grad(set_to_none=True)
        with span("train.backward"):
            total.backward()
        mesh.all_reduce_grads(model)
        with span("train.optimizer"):
            opt.step()
        return aux

    def _eager(self, host):
        with span("train.h2d"):
            batch = {k: t.to(self.dev, non_blocking=True)
                     for k, t in host.items()}
        with span("train.eager"):
            set_lr(self.optimizer, self.cfg, self.step)
            return _global_aux(self._body(batch))

    def _capture(self, host, sig):
        """Capture the step on this batch and replay it once; None where
        the capture fails (every later call then runs eagerly)."""
        dev, opt = self.dev, self.optimizer
        with span("train.h2d"):
            inputs = {k: torch.empty(t.shape, dtype=t.dtype, device=dev)
                      .copy_(t, non_blocking=True) for k, t in host.items()}
        with span("train.capture"):
            before = Counter(_build.LAUNCHES)
            graph = torch.cuda.CUDAGraph()
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            opt.zero_grad(set_to_none=True)
            torch.cuda.synchronize(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            try:
                with torch.cuda.stream(side):
                    graph.capture_begin()
                    try:
                        aux = self._body(inputs, cache=False)
                    finally:
                        graph.capture_end()
            except RuntimeError as err:
                # strings, so that no record keeps the failed capture's
                # frames (and its autograd graph) alive
                log.warning("train step: the CUDA graph's capture failed "
                            "(%s; %s); every later step runs eagerly",
                            str(err), str(err.__context__))
                self.off = True
                return None
            finally:
                launches = Counter(_build.LAUNCHES)
                launches.subtract(before)
                _build.LAUNCHES.clear()
                _build.LAUNCHES.update(before)
            torch.cuda.current_stream(dev).wait_stream(side)
        self.graph, self.sig, self.inputs = graph, sig, inputs
        self.launches = +launches
        self.aux = {k: v.detach() for k, v in aux.items()}
        self.opt_objs = (opt.state, opt.param_groups)
        return self._replay(None)

    def _replay(self, host):
        if host is not None:
            with span("train.h2d"):
                for k, t in host.items():
                    self.inputs[k].copy_(t, non_blocking=True)
        with span("train.replay"):
            set_lr(self.optimizer, self.cfg, self.step)
            self.graph.replay()
            _build.LAUNCHES.update(self.launches)
            self.model.train()
            return _aux_copy(self.aux)


def _global_aux(aux):
    """The logged losses, detached; under a process group their sums over
    the ranks, i.e. the global batch's losses (one all-reduce)."""
    if not mesh.active():
        return {k: v.detach() for k, v in aux.items()}
    vals = mesh.all_reduce_sum(torch.stack([v.detach().float()
                                            for v in aux.values()]))
    return dict(zip(aux, vals))


def make_eval_step(model: torch.nn.Module, cfg, device="cuda"):
    """Returns predict(images) -> eval-mode float32 NCHW logits on the
    device (train.py:677-684): images (B, 3, H, W) uint8 or normalised
    float32, the forward under bfloat16 autocast on the card when
    cfg.dtype == "bfloat16"."""
    from mulactseg_tpu_torch.engine.evaluate import eval_forward

    dev = resolve_device(device)
    autocast = bf16_autocast(dev, cfg)

    def predict(images):
        return eval_forward(model, images, dev, autocast)

    return predict
