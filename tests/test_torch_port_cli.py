"""The port's CLIs (mulactseg_tpu_torch/cli) against the JAX package's, on
one tiny Cityscapes-format tree on disk (tools/cityscapes_tree.py: 4
training and 2 validation images at 40x56, nseg 30, 6 classes), with the
small model twin of test_torch_port_model.py injected on both sides as
test_torch_port_rounds.py injects it (dropout off).

The chain is the recipe's (scripts/open_source/train_city_mul_res50.sh,
its flags, cut to 1 round of 4 steps at 24x24 crops and one validation):
train_al -> eval_al (pseudo-labels) -> train_stage2. Every trainer's
fresh model is the JAX package's seeded init, so the classifier leaves an
imagenet_pretrained init file leaves out are the same on both sides.
- train_al: the round-1 selection JSON and datalist_01.json byte for byte
  the JAX run's.
- eval_al: with the JAX run's round-1 checkpoint carried into the port's
  run directory, the pseudo-label PNGs are exactly the JAX run's.
- train_stage2 on those pseudo-labels from one init: the eval mIoU within
  1.0 point of the JAX run's.
The JAX side builds items on one thread, whose transform draws are the
port's in any worker count; the port's side builds them in 2 worker
processes.

Also: every command of the port's two recipe scripts parses, and its
Config equals the JAX parse of the JAX script's command field by field
(steps_per_dispatch apart); every loader branch builds, the statistics
loaders too, and an analysis eval without a validation set stops as the
JAX CLI does.
"""

import dataclasses
import os
from types import SimpleNamespace

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from mulactseg_tpu.cli import eval_al as jax_eval_al
from mulactseg_tpu.cli import train_al as jax_train_al
from mulactseg_tpu.cli import train_stage2 as jax_train_stage2
from mulactseg_tpu.config import parse_config as jax_parse_config
from mulactseg_tpu.engine import checkpoint as jax_checkpoint
from mulactseg_tpu.engine import rounds as jax_rounds
from mulactseg_tpu_torch.cli import common
from mulactseg_tpu_torch.cli import eval_al, train_al, train_stage2
from mulactseg_tpu_torch.config import Config, parse_config
from mulactseg_tpu_torch.engine import rounds
from mulactseg_tpu_torch.engine.checkpoint import save_checkpoint
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.tools.cityscapes_tree import write_tree
from mulactseg_tpu_torch.utils.png import read_gray8
from tests import test_recipe_scripts as recipe_scripts
from tests.test_torch_port_model import NC, twin_pair
from tests.test_torch_port_rounds import _port_twin

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCRIPTS = os.path.join(ROOT, "mulactseg_tpu_torch", "scripts")
NSEG, CROP = 30, 24
PLBL = os.path.join("plbl_gen_cosprop_includeonehot", "round_01")


def _common(root, dl, run, workers):
    return ["-p", str(run), "--data_root", str(root), "--datalist_dir", dl,
            "--dataset", "gta5", "--label_encoding", "cityscapes",
            "--num_classes", str(NC - 1), "--nseg", str(NSEG),
            "--crop_size", str(CROP), str(CROP), "--separable_conv",
            "--dtype", "float32", "--num_workers", str(workers),
            "--val_num_workers", str(workers)]


def _stage1(init):
    return ["--init_checkpoint", init,
            "--method", "active_joint_multi_predignore_lossdecomp",
            "--active_method", "my_bvsb_predclsbal_pwr_banignore",
            "--cls_weight_coeff", "6.0", "--or_labeling", "--fair_counting",
            "--loss_type", "joint_multi_loss", "--scheduler", "poly",
            "--train_lr", "0.0001", "--start_over", "--finetune_itrs", "4",
            "--val_period", "4", "--val_start", "0", "--max_iterations", "1",
            "--train_transform", "rescale_769_multi_notrg",
            "--loader", "region_cityscapes_or_tensor",
            "--active_selection_size", "40", "--multi_ce_temp", "0.1",
            "--group_ce_temp", "0.1", "--ce_temp", "0.1", "--coeff", "16.0",
            "--coeff_mc", "8.0", "--coeff_gm", "1.0", "--trim_kernel_size",
            "5", "--trim_multihot_boundary", "--init_iteration", "1",
            "--train_batch_size", "2", "--val_batch_size", "2"]


def _plbl(run):
    ckpt = str(run / "checkpoint01")
    return ["--stage2", "--datalist_path", str(run / "datalist_01.json"),
            "--init_checkpoint", ckpt, "--resume_checkpoint", ckpt,
            "--init_iteration", "1",
            "--method", "eval_save_cosplbl_prop_includeonehot",
            "--or_labeling", "--train_transform", "eval_spx",
            "--loader", "eval_region_cityscapes_all",
            "--trim_multihot_boundary", "--trim_kernel_size", "5",
            "--val_batch_size", "1", "--dontlog"]


def _stage2(run, init):
    return ["--stage2", "--init_iteration", "1",
            "--datalist_path", str(run / "datalist_01.json"),
            "--resume_checkpoint", str(run / "checkpoint01"),
            "--init_checkpoint", init, "--finetune_itrs", "4",
            "--val_period", "4", "--val_start", "0",
            "--active_selection_size", "50000",
            "--train_transform", "rescale_769_nospx", "--optimizer", "adamw",
            "--train_lr", "0.0004", "--ce_temp", "0.1", "--cls_lr_scale",
            "10.0", "--scheduler", "poly", "--train_batch_size", "2",
            "--val_batch_size", "2", "--dominant_labeling",
            "--method", "active_predignore",
            "--loader", "region_cityscapes_plbl",
            "--plbl_type", "cosprop_includeonehot"]


def test_recipe_chain_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, **kw: x)
    root = tmp_path / "data"
    dl = write_tree(str(root), 4, 2, 40, 56, NSEG, seed=3,
                    num_classes=NC - 1, dataset="gta5")
    port, ref = twin_pair(separable=True)
    v = convert.random_variables(port, 9)
    # an init file in each package's format; an imagenet_pretrained file
    # gives its weights only (the classifier's last layer stripped)
    jax_init = str(tmp_path / "jax_init_imagenet_pretrained")
    jax_checkpoint.save_checkpoint(jax_init, SimpleNamespace(
        params=v["params"], batch_stats=v["batch_stats"], opt_state={},
        step=0))
    port_init = str(tmp_path / "port_init_imagenet_pretrained")
    save_checkpoint(port_init, _port_twin(v))

    # the fresh model of every round is the JAX package's init (seeded by
    # cfg.seed); the port's trainers start from the same values, so both
    # keep the same classifier leaves when the init file is stripped
    fresh = {}
    real_state = jax_rounds.create_train_state

    def jax_state(*a, **k):
        state = real_state(*a, **k)
        fresh.setdefault("v", jax.tree_util.tree_map(np.array, {
            "params": state.params, "batch_stats": state.batch_stats}))
        return state

    monkeypatch.setattr(jax_rounds, "create_train_state", jax_state)
    monkeypatch.setattr(jax_rounds, "get_model", lambda *a, **k: ref)
    monkeypatch.setattr(rounds, "get_model",
                        lambda *a, **k: _port_twin(fresh["v"]))
    # one compile of each JAX step (per criterion) for the whole chain
    memo = {}
    for name in ("make_train_step", "Evaluator"):
        real = getattr(jax_rounds, name)
        monkeypatch.setattr(jax_rounds, name, lambda model, cfg, _r=real,
                            _n=name: memo.setdefault(
                                (_n, cfg.method), _r(model, cfg)))
    real_eval_step = jax_rounds.make_eval_step
    monkeypatch.setattr(jax_rounds, "make_eval_step", lambda model: memo
                        .setdefault("eval_step", real_eval_step(model)))

    jd, pd = tmp_path / "jax", tmp_path / "port"
    want = jax_train_al.main(_common(root, dl, jd, 1) + _stage1(jax_init))
    got = train_al.main(_common(root, dl, pd, 2) + _stage1(port_init),
                        device="cpu")
    assert got.keys() == want.keys() == {1}
    for f in ("my_random_selection_01.json", "datalist_01.json"):
        assert (pd / f).read_bytes() == (jd / f).read_bytes(), f
    assert (pd / "checkpoint01").exists() and (pd / "metrics.jsonl").exists()

    # the JAX run's round-1 weights carried into the port's run
    payload = jax_checkpoint.load_checkpoint(str(jd / "checkpoint01"))
    save_checkpoint(str(pd / "checkpoint01"), _port_twin(
        {"params": payload["params"], "batch_stats": payload["batch_stats"]}))
    jax_eval_al.main(_common(root, dl, jd, 1) + _plbl(jd))
    eval_al.main(_common(root, dl, pd, 2) + _plbl(pd), device="cpu")
    names = sorted(os.listdir(jd / PLBL))
    assert names and sorted(os.listdir(pd / PLBL)) == names
    for n in names:
        np.testing.assert_array_equal(read_gray8(str(pd / PLBL / n)),
                                      read_gray8(str(jd / PLBL / n)), n)

    want = jax_train_stage2.main(_common(root, dl, jd, 1)
                                 + _stage2(jd, jax_init))
    got = train_stage2.main(_common(root, dl, pd, 2) + _stage2(pd, port_init),
                            device="cpu")
    assert (pd / "stage2_checkpoint01").exists()
    assert np.isfinite(got) and abs(got - want) <= 1.0, (got, want)


def _record(script_dir, script, tmp_path):
    """tests/test_recipe_scripts.py's harness (a stub `python` that
    records its argv) on the scripts of script_dir."""
    tmp_path.mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(recipe_scripts, "SCRIPT_DIR", script_dir)
        return recipe_scripts.record_script_commands(script, tmp_path)


def _pairs(tmp_path):
    """(port script command, JAX script command) pairs, in order."""
    out = []
    for name in ("train_city_mul_res50.sh", "eval_city_mul_res50.sh"):
        port = _record(PORT_SCRIPTS, name, tmp_path / name)
        jax_cmds = _record(recipe_scripts.SCRIPT_DIR, name,
                           tmp_path / f"jax_{name}")
        assert len(port) == len(jax_cmds)
        out += list(zip(port, jax_cmds))
    return out


def test_recipe_scripts_parse_to_the_jax_configs(tmp_path):
    pairs = _pairs(tmp_path)
    assert len(pairs) == 11 + 5
    for port, jax_cmd in pairs:
        assert port[:2] == ["-m", jax_cmd[1].replace(
            "mulactseg_tpu.", "mulactseg_tpu_torch.", 1)]
        assert "--steps-per-dispatch" not in port
        got = dataclasses.asdict(parse_config(port[2:]))
        want = dataclasses.asdict(jax_parse_config(jax_cmd[2:]))
        assert want.pop("steps_per_dispatch") in (1, 32)
        got.pop("steps_per_dispatch")
        assert got == want
        assert got["dtype"] == ("bfloat16" if "train" in port[1]
                                else want["dtype"])


def test_loader_branches_left_to_port_raise(tmp_path):
    """No loader branch is left to port: the statistics loaders wrap the
    arm's labelled set (tests/test_torch_port_stats.py holds their items
    against JAX) and the branches of item 18 build
    (tests/test_torch_port_loader_arms.py); eval_naive_vis, an analysis
    eval of the validation set, stops without one."""
    root = tmp_path / "data"
    dl = write_tree(str(root), 1, 0, 16, 16, 4, seed=0, num_classes=3,
                    encoding="filter0", dataset="gta5")
    base = dict(data_root=str(root), datalist_dir=dl, nseg=4,
                num_classes=3, dataset="gta5")
    for kw in ({"loader": "region_cityscapes_count_all"},
               {"loader": "region_cityscapes_visualize_minor"},
               {"or_labeling": False, "loader": "region_cityscapes_dom_w_gt"},
               {"or_labeling": False,
                "loader": "region_cityscapes_dominant_all_sample"}):
        cfg = Config(**{**base, **kw}).derive_paths()
        active, _ = common.build_active_datasets(cfg)
        assert type(active.trg_label_dataset).__name__ == \
            "RegionStatsDataset"
        assert len(active.trg_pool_dataset) == 1
    for kw in ({"loader": "region_cityscapes_or_tensor_tinyfilter_gt"},
               {"loader": "region_cityscapes_or_oracle"},
               {"loader": "region_cityscapes_or_tensor_ignore_async"},
               {"load_smaller_spx": True},
               {"or_labeling": False, "loader": "region_cityscapes"}):
        cfg = Config(**{**base, **kw}).derive_paths()
        active, _ = common.build_active_datasets(cfg)
        assert len(active.trg_pool_dataset) == 1
    with pytest.raises(SystemExit, match="validation datalist"):
        eval_al.main(["--method", "eval_naive_vis", "-p",
                      str(tmp_path / "run"), "--data_root", str(root),
                      "--datalist_dir", dl, "--dataset", "gta5", "--nseg",
                      "4", "--num_classes", "3", "--model",
                      "deeplabv3plus_mobilenet", "--dontlog"],
                     device="cpu")
    active, val = common.build_active_datasets(
        Config(**base).derive_paths())
    assert val is None and len(active.trg_pool_dataset) == 1  # no val.txt
    assert active.trg_label_dataset.im_idx == []
