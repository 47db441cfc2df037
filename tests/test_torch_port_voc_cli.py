"""The port's VOC recipe (mulactseg_tpu_torch/scripts/train_voc_mul_res50.sh)
through its CLIs against the JAX package's CLIs, on the CPU: the script's
own command lines, recorded by a stub `python`, cut to 2 rounds of 4 steps
at 24x24 crops and run over a small VOC-format tree (tools/voc_tree.py: 4
training and 2 validation images of two odd sizes, baseline JPEGs,
palette labels, nseg 24) by both packages, with the 21-class small model
twin of test_torch_port_voc.py injected on both sides and every trainer's
fresh model the JAX package's seeded init (as test_torch_port_cli.py does
for the Cityscapes chain). TTA_SCALES is shrunk to two scales in both
packages, as tests/test_voc_tta_pipeline.py does.

- train_al, 2 rounds (my_random, then my_bvsb_predclsbal_pwr):
  selection JSON of round 1 and datalist_01/02.json byte for byte, round
  2's selected set with Jaccard 1.0.
- eval_al of each round (10-view TTA pseudo-labels, here 2 scales x 2
  flips), with the JAX run's checkpoint carried into the port's run
  directory: the pseudo-label PNGs exactly the JAX run's.
- train_stage2 of each round (plain CE, `active`) on those pseudo-labels
  from one init: the eval mIoU within 1.0 point of the JAX run's.

The chain is marked slow (as tests/test_voc_tta_pipeline.py is): run it
with `python -m pytest tests/test_torch_port_voc_cli.py`.

Also: the port's script differs from the JAX script only by the flags
the JAX package fails on (ROADMAP.md, questions for the reference's
owners): --train_transform eval_spx_identity in each eval command, and
--val_batch_size 1 in stage 1 and stage 2; every other field of each
command's Config equals the JAX parse (steps_per_dispatch apart).
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
from mulactseg_tpu.engine import tta as jax_tta
from mulactseg_tpu_torch.cli import eval_al, train_al, train_stage2
from mulactseg_tpu_torch.config import parse_config
from mulactseg_tpu_torch.engine import rounds, tta
from mulactseg_tpu_torch.engine.checkpoint import save_checkpoint
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.tools.voc_tree import write_tree
from mulactseg_tpu_torch.utils.png import read_gray8
from tests.test_torch_port_cli import PORT_SCRIPTS, _record
from tests.test_torch_port_model import jax_variables
from tests.test_torch_port_rounds import _jaccard, _selected
from tests.test_torch_port_voc import NSEG, SIZES, port_twin, voc_twins
from tests import test_recipe_scripts as recipe_scripts

torch.set_num_threads(1)

CROP, ROUNDS = 24, 2
SCRIPT = "train_voc_mul_res50.sh"


def _cut(argv, run, root, dl, init, workers):
    """A recorded command (`-m module` dropped) with the test's cuts."""
    cuts = {"--finetune_itrs": "4", "--val_period": "4",
            "--max_iterations": str(ROUNDS), "--active_selection_size": "30",
            "--train_batch_size": "2", "--nseg": str(NSEG),
            "--num_workers": str(workers), "--data_root": root}
    out = list(argv[2:])
    for i, a in enumerate(out):
        if a in cuts:
            out[i + 1] = cuts[a]
        elif a == "--crop_size":
            out[i + 1] = out[i + 2] = str(CROP)
        elif a.startswith("checkpoint/voc_mul_res50"):
            out[i] = a.replace("checkpoint/voc_mul_res50", str(run))
        elif a == "--init_checkpoint" and "imagenet" in out[i + 1]:
            out[i + 1] = init
    return out + ["--datalist_dir", dl, "--dtype", "float32",
                  "--val_num_workers", str(workers)]


@pytest.mark.slow  # ~150-190 s: the JAX CLIs' compiles and eager TTA
def test_voc_recipe_chain_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, **kw: x)
    monkeypatch.setattr(jax_tta, "TTA_SCALES", (0.75, 1.0))
    monkeypatch.setattr(tta, "TTA_SCALES", (0.75, 1.0))
    root = str(tmp_path / "data")
    dl = write_tree(root, 4, 2, NSEG, seed=4, sizes=SIZES)
    cmds = _record(PORT_SCRIPTS, SCRIPT, tmp_path / "rec")
    assert [c[1].rsplit(".", 1)[1] for c in cmds] == \
        ["train_al"] + ["eval_al", "train_stage2"] * 5
    port, ref = voc_twins()
    v = jax_variables(ref, 9)
    jax_init = str(tmp_path / "jax_init_imagenet_pretrained")
    jax_checkpoint.save_checkpoint(jax_init, SimpleNamespace(
        params=v["params"], batch_stats=v["batch_stats"], opt_state={},
        step=0))
    port_init = str(tmp_path / "port_init_imagenet_pretrained")
    save_checkpoint(port_init, port_twin(v))

    # every trainer's fresh model is the JAX package's seeded init
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
                        lambda *a, **k: port_twin(fresh["v"]))
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

    def args(i, side):
        return _cut(cmds[i], jd if side == "jax" else pd, root, dl,
                    jax_init if side == "jax" else port_init,
                    1 if side == "jax" else 2)

    want = jax_train_al.main(args(0, "jax"))
    got = train_al.main(args(0, "port"), device="cpu")
    assert got.keys() == want.keys() == {1, 2}
    for f in ("my_random_selection_01.json", "datalist_01.json",
              "datalist_02.json"):
        assert (pd / f).read_bytes() == (jd / f).read_bytes(), f
    sel = "my_bvsb_predclsbal_pwr_selection_02.json"
    a, b = _selected(pd / sel), _selected(jd / sel)
    assert len(b) > 0 and _jaccard(a, b) == 1.0, (_jaccard(a, b), len(b))

    for r in range(1, ROUNDS + 1):
        ckpt = f"checkpoint{r:02d}"
        payload = jax_checkpoint.load_checkpoint(str(jd / ckpt))
        save_checkpoint(str(pd / ckpt), port_twin(
            {"params": payload["params"],
             "batch_stats": payload["batch_stats"]}))
        jax_eval_al.main(args(2 * r - 1, "jax"))
        eval_al.main(args(2 * r - 1, "port"), device="cpu")
        plbl = os.path.join("plbl_gen_cosprop_includeonehot", f"round_{r:02d}")
        names = sorted(os.listdir(jd / plbl))
        assert names and sorted(os.listdir(pd / plbl)) == names
        for n in names:
            np.testing.assert_array_equal(read_gray8(str(pd / plbl / n)),
                                          read_gray8(str(jd / plbl / n)),
                                          f"round {r}: {n}")
        want = jax_train_stage2.main(args(2 * r, "jax"))
        got = train_stage2.main(args(2 * r, "port"), device="cpu")
        assert (pd / f"stage2_{ckpt}").exists()
        assert np.isfinite(got) and abs(got - want) <= 1.0, (r, got, want)


def test_voc_script_differs_from_jax_only_where_jax_fails(tmp_path):
    port = _record(PORT_SCRIPTS, SCRIPT, tmp_path / "port")
    jax_cmds = _record(recipe_scripts.SCRIPT_DIR, SCRIPT, tmp_path / "jax")
    assert len(port) == len(jax_cmds) == 11
    for p, j in zip(port, jax_cmds):
        assert p[:2] == ["-m", j[1].replace("mulactseg_tpu.",
                                            "mulactseg_tpu_torch.", 1)]
        assert "--steps-per-dispatch" not in p
        got = dataclasses.asdict(parse_config(p[2:]))
        want = dataclasses.asdict(jax_parse_config(j[2:]))
        for d in (got, want):
            d.pop("steps_per_dispatch")
        if p[1].endswith("eval_al"):
            assert want.pop("train_transform") == "eval_spx_identity_ms"
            assert got.pop("train_transform") == "eval_spx_identity"
        else:
            assert want.pop("val_batch_size") == 4
            assert got.pop("val_batch_size") == 1
        assert got == want
        assert got["dataset"] == "voc" and got["num_classes"] == 21
