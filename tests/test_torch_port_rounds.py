"""The port's round loop (engine/rounds.py, engine/checkpoint.py,
engine/state.make_optimizer with total_itrs / lr_mult) against the JAX
package, on the CPU and the small model twin of test_torch_port_model.py
(dropout off on both sides, as in test_torch_port_train.py).

- A checkpoint saved and loaded back is bitwise the weights, optimizer
  state and step that were saved; the JAX package's
  models/torch_import.load_torch_checkpoint reads a port checkpoint and
  gets convert.state_dict_to_variables of its weights exactly (of a
  separable head, every leaf but the separable kernels, which that
  reader has no names for and skips).
- merge_pretrained with the classifier stripped equals the JAX
  package's on the same trees: classifier.final / proxy keep their fresh
  values, a leaf of another shape stays fresh, the rest is copied.
- make_optimizer(total_itrs, lr_mult) sets the per-step LRs of the JAX
  package's poly schedule at base LR x lr_mult (rtol 1e-6: optax
  evaluates it in float32) and, fed the same gradients as optax, moves
  the parameters alike (atol 5e-6).
- The weight policy of tests/test_rounds_policy.py: round 2 selects with
  round 1's checkpoint, and start_over trains both rounds from the init.
- A free-running 2-round run_al_rounds against the JAX package's from
  one init (an Orbax file and a port file of the same variables):
  round 1's selection JSON and datalist byte for byte, round 2's selected
  set with Jaccard 1.0 (its scores come from two trained models, which
  agree to ~1e-4), and each round's eval mIoU within 1.0 point.
"""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import optax
import torch

from mulactseg_tpu.active import RegionActiveSet as JaxActiveSet
from mulactseg_tpu.config import Config as JaxConfig
from mulactseg_tpu.data.synthetic import SyntheticRegionDataset as JaxDataset
from mulactseg_tpu.engine import checkpoint as jax_checkpoint
from mulactseg_tpu.engine import rounds as jax_rounds
from mulactseg_tpu.engine.state import create_train_state
from mulactseg_tpu.engine.state import make_optimizer as jax_make_opt
from mulactseg_tpu.models.torch_import import load_torch_checkpoint
from mulactseg_tpu.utils.schedule import poly_lr as jax_poly_lr
from mulactseg_tpu_torch.active import RegionActiveSet
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset
from mulactseg_tpu_torch.engine import rounds
from mulactseg_tpu_torch.engine.checkpoint import (
    load_checkpoint,
    merge_pretrained,
    save_checkpoint,
)
from mulactseg_tpu_torch.engine.state import make_optimizer, set_lr
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.models.layers import Dropout
from tests.test_torch_port_model import NC, _flat, jax_variables, twin_pair

torch.set_num_threads(1)

HH, NSEG = 33, 16


def _port_twin(variables):
    port, _ = twin_pair(separable=True)
    convert.load_variables(port, variables)
    for m in port.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return port


def _cfg_kw(tmp, **kw):
    base = dict(num_classes=NC - 1, nseg=NSEG, crop_size=(HH, HH),
                train_batch_size=4, finetune_itrs=4, val_period=2,
                val_start=0, max_iterations=2, active_selection_size=24,
                val_batch_size=4, num_workers=2, val_num_workers=2,
                model_save_dir=str(tmp), dtype="float32", train_lr=1e-4,
                cls_lr_scale=10.0, n_devices=1,
                method="active_joint_multi_predignore_lossdecomp")
    base.update(kw)
    return base


def _datasets(cls, n=6, seed=1):
    mk = lambda s: cls(n_images=n, H=HH, W=HH, num_classes=NC - 1,
                       nseg=NSEG, split=s, seed=seed)
    pool, label, val = mk("active-ulabel"), mk("active-label"), mk("val")
    label.suppix, label.im_idx = {}, []
    return pool, label, val


@pytest.mark.parametrize("separable", [False, True])
def test_checkpoint_round_trip_and_torch_import(tmp_path, separable):
    port, _ = twin_pair(separable)
    convert.load_variables(port, convert.random_variables(port, 3))
    cfg = Config(**_cfg_kw(tmp_path))
    opt = make_optimizer(port, cfg, total_itrs=7, lr_mult=2.0)
    rng = np.random.RandomState(0)
    for it in range(2):  # a non-empty optimizer state
        set_lr(opt, cfg, it)
        for p in port.parameters():
            p.grad = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
        opt.step()
    path = str(tmp_path / "checkpoint01")
    save_checkpoint(path, port, opt, step=2)
    assert os.listdir(tmp_path) == ["checkpoint01"]
    payload = load_checkpoint(path)
    assert payload["step"] == 2
    want = port.state_dict()
    assert payload["model_state_dict"].keys() == want.keys()
    for k, t in want.items():
        assert torch.equal(payload["model_state_dict"][k], t), k

    fresh, _ = twin_pair(separable)
    convert.load_variables(fresh, convert.random_variables(fresh, 4))
    fopt = make_optimizer(fresh, cfg)
    fresh.load_state_dict(payload["model_state_dict"])
    fopt.load_state_dict(payload["optimizer_state_dict"])
    for k, t in want.items():
        assert torch.equal(fresh.state_dict()[k], t), k
    a, b = opt.state_dict(), fopt.state_dict()
    assert a["param_groups"] == b["param_groups"]
    assert a["state"].keys() == b["state"].keys() and len(a["state"])
    for i, st in a["state"].items():
        for k, t in st.items():
            assert torch.equal(b["state"][i][k], t), (i, k)

    # the JAX package's reader of reference checkpoints; it has no names
    # for a separable convolution's two kernels (<conv>.body.{0,1}) and
    # skips them, so there it reads every other leaf
    got = _flat(load_torch_checkpoint(path))
    want_v = _flat(convert.state_dict_to_variables(want))
    skipped = set(want_v) - set(got)
    assert not set(got) - set(want_v)
    assert all(k.endswith(("depthwise/kernel", "pointwise/kernel"))
               for k in skipped) and bool(skipped) == separable
    for k in got:
        np.testing.assert_array_equal(got[k], want_v[k], err_msg=k)


def test_merge_pretrained_matches_jax():
    port, _ = twin_pair(separable=True)
    fresh = convert.random_variables(port, 5)
    pre = convert.random_variables(port, 6)
    # one leaf of another shape: kept at its fresh value by both
    pre["params"]["classifier"]["project"]["bn"]["scale"] = np.ones(
        5, np.float32)
    fresh_sd = convert.variables_to_state_dict(fresh)
    pre_sd = convert.variables_to_state_dict(convert.random_variables(
        port, 6))
    pre_sd["classifier.project.1.weight"] = torch.ones(5)
    got = merge_pretrained(fresh_sd, pre_sd)
    want = {c: jax_checkpoint.merge_pretrained(
        fresh[c], pre[c], strip_classifier_final=c == "params")
        for c in ("params", "batch_stats")}
    want_sd = convert.variables_to_state_dict(want)
    assert got.keys() == want_sd.keys()
    for k in want_sd:
        assert torch.equal(got[k], want_sd[k]), k
    for k in ("classifier.proxy", "classifier.project.1.weight"):
        assert torch.equal(got[k], fresh_sd[k]), k
    assert torch.equal(got["classifier.aspp.project.0.weight"],
                       pre_sd["classifier.aspp.project.0.weight"])


def test_optimizer_total_itrs_and_lr_mult_match_optax():
    steps, total, mult = 6, 4, 3.0
    cfg_kw = dict(train_lr=1e-3, cls_lr_scale=10.0, weight_decay=5e-2,
                  power=0.9, min_lr=1e-4, finetune_itrs=100)
    cfg, jcfg = Config(**cfg_kw), JaxConfig(**cfg_kw)
    rng = np.random.RandomState(1)
    shapes = {"backbone.w": (3, 4), "classifier.w": (5,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(steps)]
    model = torch.nn.Module()
    for part in ("backbone", "classifier"):
        sub = torch.nn.Module()
        sub.w = torch.nn.Parameter(torch.from_numpy(init[f"{part}.w"].copy()))
        model.add_module(part, sub)
    opt = make_optimizer(model, cfg, total_itrs=total, lr_mult=mult)

    def tree(d):
        return {"backbone": {"w": d["backbone.w"]},
                "classifier": {"w": d["classifier.w"]}}

    tx = jax_make_opt(jcfg, total, lr_mult=mult)
    params = jax.tree_util.tree_map(jnp.asarray, tree(init))
    opt_state = tx.init(params)
    for it, g in enumerate(grads):
        set_lr(opt, cfg, it)
        for group, scale in zip(opt.param_groups, (1.0, cfg.cls_lr_scale)):
            want = float(jax_poly_lr(cfg.train_lr * mult * scale, total,
                                     cfg.power, cfg.min_lr)(it))
            np.testing.assert_allclose(group["lr"], want, rtol=1e-6)
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(g[name])
        opt.step()
        upd, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, tree(g)), opt_state, params)
        params = optax.apply_updates(params, upd)
    assert opt.param_groups[0]["lr"] == cfg.min_lr  # past total_itrs
    for name, p in model.named_parameters():
        part = name.split(".")[0]
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params[part]["w"]), rtol=0,
                                   atol=5e-6, err_msg=name)


def _fingerprint(model):
    return float(sum(p.detach().double().abs().sum()
                     for p in model.state_dict().values()))


def test_multi_round_weight_policy(tmp_path, monkeypatch):
    """tests/test_rounds_policy.py's policy on the port: round 2 selects
    with round 1's checkpoint, start_over trains each round from the same
    fresh init."""
    v = convert.random_variables(twin_pair(separable=True)[0], 8)
    monkeypatch.setattr(rounds, "get_model", lambda *a, **k: _port_twin(v))
    cfg = Config(**_cfg_kw(tmp_path, finetune_itrs=3, val_period=100,
                           train_lr=1e-3))
    pool, label, _ = _datasets(SyntheticRegionDataset, n=3)
    active = RegionActiveSet(cfg, pool, label)
    sel_fp, train_fp, loaded = {}, {}, {}
    real_get = rounds.get_selector

    def spy_get(name, cfg):
        sel = real_get(name, cfg)
        orig = sel.select_next_batch

        def wrapper(trainer, active_set, n):
            sel_fp[trainer.selection_iter] = _fingerprint(trainer.model)
            loaded[trainer.selection_iter] = trainer.loaded
            return orig(trainer, active_set, n)

        sel.select_next_batch = wrapper
        return sel

    orig_train = rounds.ALTrainer.train

    def spy_train(self, *a, **k):
        train_fp[self.selection_iter] = (_fingerprint(self.model), self.step,
                                         len(self.optimizer.state))
        return orig_train(self, *a, **k)

    monkeypatch.setattr(rounds, "get_selector", spy_get)
    monkeypatch.setattr(rounds.ALTrainer, "train", spy_train)
    rounds.run_al_rounds(cfg, active, device="cpu")

    ckpt1 = load_checkpoint(str(tmp_path / "checkpoint01"))
    assert (tmp_path / "checkpoint02").exists() and ckpt1["step"] == 3
    fp1 = float(sum(t.double().abs().sum()
                    for t in ckpt1["model_state_dict"].values()))
    assert loaded == {1: False, 2: True}
    assert np.isclose(sel_fp[2], fp1, rtol=1e-12)
    assert not np.isclose(sel_fp[2], sel_fp[1], rtol=1e-6)
    # start_over: both rounds train from the identical init, step 0 and a
    # fresh (empty) optimizer state
    assert train_fp[1] == train_fp[2] == (sel_fp[1], 0, 0)


def _jaccard(a, b):
    return len(a & b) / max(len(a | b), 1)


def _selected(path):
    with open(path) as f:
        return {(p, i) for _, p, i in json.load(f)}


def test_two_rounds_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, **kw: x)
    _, ref = twin_pair(separable=True)
    v = jax_variables(ref, 9)
    sel2 = "my_bvsb_predclsbal_pwr_banignore"
    jcfg = JaxConfig(**_cfg_kw(tmp_path / "jax"))
    cfg = Config(**_cfg_kw(tmp_path / "port"))
    assert cfg.init_active_method == "my_random" and \
        cfg.active_method == sel2

    # one init, written in each package's format
    state = create_train_state(ref, jcfg, jax.random.PRNGKey(0),
                               (4, HH, HH, 3), total_itrs=jcfg.finetune_itrs)
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"],
                          opt_state=state.tx.init(v["params"]))
    jax_init = str(tmp_path / "jax_init")
    jax_checkpoint.save_checkpoint(jax_init, state)
    port_init = str(tmp_path / "port_init")
    save_checkpoint(port_init, _port_twin(v))

    monkeypatch.setattr(jax_rounds, "get_model", lambda *a, **k: ref)
    monkeypatch.setattr(rounds, "get_model", lambda *a, **k: _port_twin(v))
    # the JAX trainer builds fresh jitted steps every round; reuse the
    # first round's (same model, same config) to spare the CPU compiles
    for name in ("make_train_step", "make_eval_step"):
        real = getattr(jax_rounds, name)
        memo = {}
        monkeypatch.setattr(jax_rounds, name, lambda *a, _r=real, _m=memo,
                            **k: _m.setdefault("f", _r(*a, **k)))
    jax_eval = jax_rounds.Evaluator(ref, jcfg)
    monkeypatch.setattr(jax_rounds, "Evaluator", lambda *a, **k: jax_eval)

    jpool, jlabel, jval = _datasets(JaxDataset)
    want = jax_rounds.run_al_rounds(
        jcfg, JaxActiveSet(jcfg, jpool, jlabel), val_dataset=jval,
        eval_dataset=jval, init_checkpoint=jax_init)
    pool, label, val = _datasets(SyntheticRegionDataset)
    got = rounds.run_al_rounds(
        cfg, RegionActiveSet(cfg, pool, label), val_dataset=val,
        eval_dataset=val, init_checkpoint=port_init, device="cpu")

    jd, pd = tmp_path / "jax", tmp_path / "port"
    for f in ("my_random_selection_01.json", "datalist_01.json"):
        assert (pd / f).read_bytes() == (jd / f).read_bytes(), f
    for d in (jd, pd):
        assert (d / "checkpoint01").exists() and (d / "checkpoint02").exists()
    a = _selected(pd / f"{sel2}_selection_02.json")
    b = _selected(jd / f"{sel2}_selection_02.json")
    assert len(b) > 0 and _jaccard(a, b) == 1.0, (_jaccard(a, b), len(b))
    assert got.keys() == want.keys() == {1, 2}
    for r in (1, 2):
        assert abs(got[r] - want[r]) <= 1.0, (r, got[r], want[r])
    assert label.suppix == jlabel.suppix and pool.suppix == jpool.suppix
