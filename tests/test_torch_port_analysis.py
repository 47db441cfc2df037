"""The port's analysis evals and top-1 selection probe
(mulactseg_tpu_torch/engine/analysis.py, cli/eval_al.py's branches)
against the JAX package, on the CPU.

- top1_selection_counts on the same logits: exactly (integer counts), with
  an absent superpixel, GT 255 (counted as incorrect in the totals, left
  out of the class bins), and an all-masked image that adds nothing; K5
  (its plain version here) once an image.
- Every method of ANALYSIS_METHODS through AnalysisEvaluator on the small
  model twin: the pseudo-label methods' maps come from the twins'
  float32 forwards, ~1e-5 apart, so their tables agree within 0.5 points
  (as test_torch_port_plbl.py holds the generator); eval_all_dominant
  (no forward) and eval_naive_vis exactly. The overlays agree on >= 99%
  of pixels, and exactly where no forward makes them.
- SelectionAccuracyEvaluator: the same counts and accuracies.
- eval_al.main for eval_selected_spx_plbl (exclude_round from
  datalist_01.json, the vis_<method>_<NN> overlays) and for
  active_joint_multi_analysis (the labelled set with load_gt) against the
  JAX CLI on a 40x56 tree: the mIoU within 0.5 points and the overlays on
  >= 99% of pixels; the probe's accuracy exactly. The JAX CLI cannot run
  eval_all_dominant (its loader gives the multi-hot 'target'), and the
  port's raises saying so (ROADMAP.md, question 7).
"""

import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from PIL import Image

from mulactseg_tpu.cli import eval_al as jax_eval_al
from mulactseg_tpu.config import Config as JaxConfig
from mulactseg_tpu.engine import analysis as jax_analysis
from mulactseg_tpu.engine import checkpoint as jax_checkpoint
from mulactseg_tpu.engine import rounds as jax_rounds
from mulactseg_tpu_torch.cli import eval_al
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.engine import rounds
from mulactseg_tpu_torch.engine.analysis import (
    ANALYSIS_METHODS,
    AnalysisEvaluator,
    SelectionAccuracyEvaluator,
    top1_selection_counts,
)
from mulactseg_tpu_torch.engine.checkpoint import save_checkpoint
from mulactseg_tpu_torch.data.transforms import normalize
from mulactseg_tpu_torch.tools.cityscapes_tree import write_tree
from mulactseg_tpu_torch.utils.png import read_rgb8
from tests.test_torch_port_model import NC
from tests.test_torch_port_plbl import _twin_batches
from tests.test_torch_port_simple_plbl import (  # noqa: F401
    _dominant_batches,
    count_k5,
    twin,
)

torch.set_num_threads(1)

B, H, W, S, C = 3, 16, 16, 7, 5


def _probe_case(seed=3):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, H, W, C).astype(np.float32)
    spx = rng.randint(0, S, (B, H, W)).astype(np.int32)
    spx[1][spx[1] == 3] = 0  # an absent superpixel
    spmask = rng.rand(B, H, W) < 0.7
    spmask[2] = False  # an all-masked image
    multihot = (rng.rand(B, S, C + 1) < 0.5).astype(np.float32)
    gt = rng.randint(0, C, (B, H, W)).astype(np.int32)
    gt[rng.rand(B, H, W) < 0.1] = 255
    return logits, multihot, spx, spmask, gt


def test_top1_selection_counts_match_jax():
    logits, multihot, spx, spmask, gt = _probe_case()
    with count_k5() as calls:
        got = top1_selection_counts(
            torch.from_numpy(logits.transpose(0, 3, 1, 2).copy()),
            torch.from_numpy(multihot), torch.from_numpy(spx),
            torch.from_numpy(spmask), torch.from_numpy(gt), nseg=S,
            num_classes=C)
    assert len(calls) == B
    want = jax_analysis.top1_selection_counts(
        jnp.asarray(logits), jnp.asarray(multihot), jnp.asarray(spx),
        jnp.asarray(spmask), jnp.asarray(gt), nseg=S, num_classes=C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the all-masked image adds nothing
    only = top1_selection_counts(
        torch.from_numpy(logits[2:].transpose(0, 3, 1, 2).copy()),
        *(torch.from_numpy(a[2:]) for a in (multihot, spx, spmask, gt)),
        nseg=S, num_classes=C)
    assert all(float(t.sum()) == 0 for t in only)
    # GT 255 at a picked pixel: counted as incorrect, in no class bin
    assert float(got[1].sum()) < float(got[3]) and float(got[3]) > 0


def _analysis_batches(method):
    jax_b, port_b, suppix = _twin_batches(2)
    if method == "eval_all_dominant":
        port_b, jax_b = _dominant_batches(port_b, jax_b)
    elif method == "eval_naive_vis":
        # the validation set's items: normalised images, labels with 255
        for pb, jb in zip(port_b, jax_b):
            for b in (pb, jb):
                b["labels"] = np.where(b["labels"] == NC - 1, 255,
                                       b["labels"])
            pb["images"] = normalize(jb["images"][0])[None]
            jb["images"] = pb["images"].transpose(0, 2, 3, 1)
    return jax_b, port_b, suppix


@pytest.mark.parametrize("method", sorted(ANALYSIS_METHODS))
def test_analysis_method_matches_jax(method, twin, tmp_path):
    port, ref, v = twin
    jax_b, port_b, suppix = _analysis_batches(method)
    prev = {k: ids[:5] for k, ids in suppix.items()}
    kw = dict(num_classes=NC - 1, nseg=16, dtype="float32", method=method)
    want = jax_analysis.AnalysisEvaluator(ref, JaxConfig(**kw), method).run(
        v["params"], v["batch_stats"], jax_b, suppix=suppix,
        prev_suppix=prev, save_dir=str(tmp_path / "jax"))
    with count_k5() as calls:
        got = AnalysisEvaluator(port, Config(**kw), method,
                                device="cpu").run(
            None, port_b, suppix=suppix, prev_suppix=prev,
            save_dir=str(tmp_path / "port"))
    opts = ANALYSIS_METHODS[method]
    assert len(calls) == (2 if opts.get("plbl", "").startswith("cos")
                          else 0)
    assert got.keys() == want.keys()
    exact = "plbl" not in opts
    for k in got:
        if k == "miou":
            assert abs(got[k] - want[k]) <= (1e-9 if exact else 0.5)
        elif k == "ignore_iou":
            assert got[k] == want[k]
        else:
            g = np.array(got[k].split(","), float)
            w = np.array(want[k].split(","), float)
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=0 if exact else 0.5)
    if opts.get("save_vis"):
        names = sorted(os.listdir(tmp_path / "jax"))
        assert names and sorted(os.listdir(tmp_path / "port")) == names
        for name in names:
            a = np.asarray(Image.open(tmp_path / "jax" / name))
            b = read_rgb8(str(tmp_path / "port" / name))
            assert a.shape == b.shape
            assert (a == b).all(-1).mean() >= (1.0 if exact else 0.99)


def test_selection_accuracy_evaluator_matches_jax(twin):
    port, ref, v = twin
    _, port_b, _ = _twin_batches(3)
    rng = np.random.RandomState(2)
    batches = []
    for b in port_b:
        gt = np.where(b["labels"] == NC - 1, 255, b["labels"])
        # the labelled set's items: normalised images, the GT with 255
        batches.append({**b, "labels": gt,
                        "images": normalize(b["images"][0].transpose(
                            1, 2, 0).copy())[None],
                        "spmask": b["spmask"] & (rng.rand(1, 32, 32) < 0.8)})
    kw = dict(num_classes=NC, nseg=16, dtype="float32",
              method="active_joint_multi_analysis")
    got = SelectionAccuracyEvaluator(port, Config(**kw), device="cpu").run(
        None, batches)
    want = jax_analysis.SelectionAccuracyEvaluator(ref, JaxConfig(**kw)).run(
        v["params"], v["batch_stats"],
        [{**b, "images": b["images"].transpose(0, 2, 3, 1)}
         for b in batches])
    assert got["acc_total"] == want["acc_total"] and got["n_total"] > 0
    np.testing.assert_array_equal(got["n_cls"], want["n_cls"])
    np.testing.assert_array_equal(got["acc_cls"], want["acc_cls"])


@pytest.fixture
def tree_run(tmp_path, twin, monkeypatch):
    """A 3 + 1 image tree, the twin's weights as each package's round-1
    checkpoint, and round-1 and round-2 datalists of the labelled set."""
    port, ref, v = twin
    root = tmp_path / "data"
    dl = write_tree(str(root), 3, 1, 40, 56, 30, seed=3,
                    num_classes=NC - 1, dataset="gta5")
    monkeypatch.setattr(jax_rounds, "get_model", lambda *a, **k: ref)
    monkeypatch.setattr(rounds, "get_model", lambda *a, **k: port)
    with open(os.path.join(dl, "train_seed30.txt")) as f:
        rows = [[str(root / p) for p in line.split("\t")]
                for line in f.read().splitlines()]
    rng = np.random.RandomState(0)
    sel = {r[2]: sorted(rng.choice(30, 15, replace=False).tolist())
           for r in rows}
    runs = {}
    for name in ("jax", "port"):
        run = tmp_path / name
        run.mkdir()
        for rnd, suppix in ((1, {k: s[:5] for k, s in sel.items()}),
                            (2, sel)):
            (run / f"datalist_{rnd:02d}.json").write_text(json.dumps({
                "trg_label_im_idx": rows, "trg_pool_im_idx": [],
                "trg_label_suppix": suppix, "trg_pool_suppix": {}}))
        runs[name] = run
    jax_checkpoint.save_checkpoint(
        str(runs["jax"] / "checkpoint02"), type("S", (), {
            "params": v["params"], "batch_stats": v["batch_stats"],
            "opt_state": {}, "step": 0})())
    save_checkpoint(str(runs["port"] / "checkpoint02"), port)

    def argv(name, method, *extra):
        run = runs[name]
        ck = str(run / "checkpoint02")
        return ["-p", str(run), "--data_root", str(root), "--datalist_dir",
                dl, "--dataset", "gta5", "--label_encoding", "cityscapes",
                "--nseg", "30", "--separable_conv", "--dtype", "float32",
                "--num_workers", "0", "--val_num_workers", "0",
                "--init_checkpoint", ck, "--resume_checkpoint", ck,
                "--init_iteration", "2", "--datalist_path",
                str(run / "datalist_02.json"), "--or_labeling",
                "--trim_multihot_boundary", "--trim_kernel_size", "5",
                "--dontlog", "--method", method, *extra]

    return argv, runs


def test_cli_analysis_and_probe_match_jax(tree_run, monkeypatch):
    argv, runs = tree_run
    method = "eval_selected_spx_plbl"
    want = jax_eval_al.main(argv("jax", method, "--num_classes",
                                 str(NC - 1)))
    got = eval_al.main(argv("port", method, "--num_classes", str(NC - 1)),
                       device="cpu")
    assert abs(got - want) <= 0.5
    vis = f"vis_{method}_02"
    names = sorted(os.listdir(runs["jax"] / vis))
    assert names and sorted(os.listdir(runs["port"] / vis)) == names
    for n in names:
        a = np.asarray(Image.open(runs["jax"] / vis / n))
        b = read_rgb8(str(runs["port"] / vis / n))
        assert (a == b).all(-1).mean() >= 0.99

    # the probe's model has num_classes outputs: the twin's NC
    probe = "active_joint_multi_analysis"
    extra = ("--num_classes", str(NC), "--train_batch_size", "2",
             "--crop_size", "24", "24")
    want = jax_eval_al.main(argv("jax", probe, *extra))
    got = eval_al.main(argv("port", probe, *extra), device="cpu")
    assert 0.0 < got <= 1.0 and got == want

    with pytest.raises(ValueError, match="question 7"):
        eval_al.main(argv("port", "eval_all_dominant", "--num_classes",
                          str(NC - 1)), device="cpu")
