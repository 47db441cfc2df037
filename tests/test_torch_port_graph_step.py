"""The train step's CUDA graph (engine/train.py make_train_step), what of
it the CPU reaches. The capture and the replays run on the card only
(tests/test_torch_port_cuda.py, test_graph_step_*); here:

- the engagement rule: graphable() holds on a CUDA device (mocked: a
  torch.device and a stand-in optimizer whose LRs are tensors) and fails
  for each condition alone (the CPU, a process group, each criterion flag
  that keeps the step eager, anomaly detection, Python-float LRs); the
  batch signature tells another crop size, another dtype and another key
  set apart, and not another batch of the same shapes;
- engine/state: AdamW on the CPU and SGD keep float LRs; set_lr fills a
  tensor LR in place; ALTrainer keeps its own LR holder and capturable
  flag when it loads a state written on another device;
- two steps' train_loss tensors are distinct objects, each holding its
  own step's value: the eager step's, and the replay's copy (_aux_copy)
  taken from static tensors that the next replay overwrites;
- the CPU step runs eagerly: train.eager once a step, no capture, no
  replay;
- a dropped step is freed at once (nothing refers back to it), so a
  card's graph memory goes with it, not at the next garbage collection.
"""

import gc
import types
import weakref

import numpy as np
import pytest
import torch

from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.data.loader import DataProvider
from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset
from mulactseg_tpu_torch.engine import rounds
from mulactseg_tpu_torch.engine import train as port_train
from mulactseg_tpu_torch.engine.state import device_lrs, make_optimizer, set_lr
from mulactseg_tpu_torch.engine.train import (
    _aux_copy,
    _signature,
    get_criterion,
    graphable,
    make_train_step,
)
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.utils import spans
from tests import torch_port_parallel_ranks as ranks

torch.set_num_threads(1)

HH, NSEG = 33, 16
CUDA = torch.device("cuda")


def _cfg(tmp_path, **kw):
    base = dict(num_classes=ranks.NC - 1, nseg=NSEG, crop_size=(HH, HH),
                train_batch_size=4, finetune_itrs=4, num_workers=1,
                model_save_dir=str(tmp_path), dtype="float32",
                train_lr=1e-4, cls_lr_scale=10.0, n_devices=1,
                method="active_joint_multi_predignore_lossdecomp")
    base.update(kw)
    return Config(**base)


def _model(seed=9):
    model = ranks.port_twin(True)
    convert.load_variables(model, convert.random_variables(model, seed))
    return model


def _batches(n=2, hw=HH):
    data = SyntheticRegionDataset(n_images=6, H=hw, W=hw,
                                  num_classes=ranks.NC - 1, nseg=NSEG,
                                  split="active-label", seed=1)
    loader = DataProvider(data, 4, num_workers=1, seed=0)
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


def _card_opt():
    """A stand-in for the card's AdamW: device-tensor LRs, capturable."""
    return types.SimpleNamespace(param_groups=[
        {"lr": torch.zeros(()), "capturable": True} for _ in range(2)])


class _Criterion:
    def __init__(self, flag=None):
        if flag:
            setattr(self, flag, True)


def _host(batch, keys):
    return {k: torch.as_tensor(batch[k]) for k in keys if k in batch}


@pytest.mark.parametrize("case,want", [
    ("all_hold", True),
    ("cpu", False),
    ("process_group", False),
    ("needs_feat", False),
    ("needs_weak_forward", False),
    ("needs_rng", False),
    ("anomaly_detection", False),
    ("float_lrs", False),
    ("same_signature", True),
    ("other_crop_size", False),
    ("other_dtype", False),
    ("other_keys", False),
])
def test_graph_engagement_rule(case, want, monkeypatch, tmp_path):
    dev, crit, opt = CUDA, _Criterion(), _card_opt()
    if case in ("same_signature", "other_crop_size", "other_dtype",
                "other_keys"):
        keys = ("images", "target_bits", "target", "spx", "spmask")
        a, b = _batches(2)
        if case == "other_crop_size":
            b = _batches(1, hw=HH - 8)[0]
        elif case == "other_dtype":
            b = dict(b, images=np.asarray(b["images"], np.float64))
        elif case == "other_keys":
            b = {k: v for k, v in b.items() if k != "target_bits"}
        assert (_signature(_host(a, keys)) == _signature(_host(b, keys))) \
            is want
        return
    if case == "cpu":
        dev = torch.device("cpu")
    elif case == "process_group":
        monkeypatch.setattr(port_train.mesh, "active", lambda: True)
    elif case.startswith("needs_"):
        crit = _Criterion(case)
    elif case == "float_lrs":
        opt = make_optimizer(_model(), _cfg(tmp_path))
    if case == "anomaly_detection":
        with torch.autograd.set_detect_anomaly(True):
            assert graphable(dev, crit, opt) is want
    else:
        assert graphable(dev, crit, opt) is want


def test_the_real_criteria_flags():
    """The recipe's criteria qualify; the needs_feat, needs_weak_forward
    and needs_rng ones do not."""
    for method, want in [
            ("active_joint_multi_predignore_lossdecomp", True),
            ("active_joint_multi_lossdecomp", True),
            ("active_predignore", True),
            ("active_pwce_multi_predignore", False),
            ("active_joint_hier_multi_async", False)]:
        crit = get_criterion(Config(method=method, nseg_list=(8, 16)))
        assert graphable(CUDA, crit, _card_opt()) is want, method
    crit = get_criterion(Config(method="active_joint_multi_ablation",
                                loss_type="rand_multi_ce"))
    assert not graphable(CUDA, crit, _card_opt())


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_cpu_and_sgd_keep_float_lrs(optimizer, tmp_path):
    cfg = _cfg(tmp_path, optimizer=optimizer)
    opt = make_optimizer(_model(), cfg)
    assert not device_lrs(opt)
    assert all(isinstance(g["lr"], float) for g in opt.param_groups)
    assert not any(g.get("capturable") for g in opt.param_groups)
    set_lr(opt, cfg, 2)
    assert all(isinstance(g["lr"], float) for g in opt.param_groups)


def test_set_lr_fills_a_tensor_lr_in_place(tmp_path):
    cfg = _cfg(tmp_path)
    opt = make_optimizer(_model(), cfg)
    want = []
    for it in (0, 3):
        set_lr(opt, cfg, it)
        want.append([g["lr"] for g in opt.param_groups])
    held = [torch.zeros(()) for _ in opt.param_groups]
    for g, t in zip(opt.param_groups, held):
        g["lr"], g["capturable"] = t, True
    assert device_lrs(opt)
    for it, lrs in zip((0, 3), want):
        set_lr(opt, cfg, it)
        for g, t, lr in zip(opt.param_groups, held, lrs):
            assert g["lr"] is t
            assert float(t) == pytest.approx(lr, rel=1e-6)


@pytest.mark.parametrize("written_on", ["card", "cpu"])
def test_load_optimizer_keeps_this_devices_lr_holder(written_on, tmp_path):
    """ALTrainer._load_optimizer: the moments come from the file, the LR
    holder and the capturable flag stay this trainer's."""
    cfg = _cfg(tmp_path)
    src = rounds.ALTrainer(cfg, 1, model=_model(3), device="cpu")
    src.train_step(_batches(1)[0])
    state = src.optimizer.state_dict()
    if written_on == "card":  # as the card's AdamW writes it
        state["param_groups"] = [dict(g, lr=torch.tensor(float(g["lr"])),
                                      capturable=True)
                                 for g in state["param_groups"]]
    dst = rounds.ALTrainer(cfg, 2, model=_model(4), device="cpu")
    if written_on == "cpu":  # this trainer holds its LRs as the card's
        for g in dst.optimizer.param_groups:
            g["lr"], g["capturable"] = torch.zeros(()), True
    own = [(g["lr"], g["capturable"], g["base_lr"])
           for g in dst.optimizer.param_groups]
    dst._load_optimizer(state)
    for g, (lr, cap, base) in zip(dst.optimizer.param_groups, own):
        assert type(g["lr"]) is type(lr) and g["capturable"] == cap
        assert g["base_lr"] == base
    got = dst.optimizer.state_dict()["state"]
    assert got.keys() == state["state"].keys() and len(got)
    for i in got:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got[i][k], state["state"][i][k]), (i, k)


def test_each_step_returns_its_own_losses(tmp_path):
    step = make_train_step(_model(), _cfg(tmp_path), device="cpu")
    before = spans.snapshot()
    out = [step(b) for b in _batches(2)]
    a, b = (o["train_loss"] for o in out)
    assert a is not b
    assert float(a) != float(b)
    # the CPU step is eager: no capture, no replay
    now = spans.snapshot()
    count = {n: now.get(n, (0,))[0] - before.get(n, (0,))[0]
             for n in ("train.step", "train.eager", "train.capture",
                       "train.replay")}
    assert count == {"train.step": 2, "train.eager": 2, "train.capture": 0,
                     "train.replay": 0}

    # the replay's copy: static tensors that each replay overwrites
    static = {"ce_loss": torch.tensor(1.0), "train_loss": torch.tensor(2.0)}
    first = _aux_copy(static)
    for v in static.values():
        v.mul_(10.0)
    second = _aux_copy(static)
    assert first["train_loss"] is not second["train_loss"]
    assert [float(v) for v in first.values()] == [1.0, 2.0]
    assert [float(v) for v in second.values()] == [10.0, 20.0]
    assert list(second) == ["ce_loss", "train_loss"]


def test_a_dropped_step_is_freed_at_once(tmp_path):
    step = make_train_step(_model(), _cfg(tmp_path), device="cpu")
    step(_batches(1)[0])
    ref = weakref.ref(step)
    gc.disable()
    try:
        del step
        assert ref() is None
    finally:
        gc.enable()
