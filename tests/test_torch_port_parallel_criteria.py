"""Every criterion of the port (engine/train.CRITERIA) and the unfused
lossdecomp at world 2 against world 1, and the analysis evals and the
top-1 probe through cli.eval_al at world 2 against world 1.

Two gloo ranks started by parallel.spawn run every job of
tests/torch_port_parallel_ranks.py in one group; the same jobs run in
the test process without a group as world 1. The small model twin of
test_torch_port_model.py at 33x33 (dropout off), global batch 4, nseg
12, float32.

- Step 0 of each criterion (every CRITERIA entry but the fused
  lossdecomp and the CE criteria, which test_torch_port_parallel.py
  holds; the ablation under its three loss types, the hierarchy
  criterion with --nocropsp, async_weight with weight_reduce 'mean', the
  online options) on each rank's two rows of one batch that carries
  every key a criterion reads: the logged loss parts within 1e-5
  relative of world 1's, each rank's returned loss its share of world
  1's (their sum within 1e-5), the gradients (summed over the ranks)
  within 1e-4 relative in L2 over all leaves, equal on both ranks; K5 on
  each rank for its own images, the two ranks' calls summing to world
  1's. The rand_multi_ce ablation draws world 1's classes (each rank
  drawing its own rows' uniforms instead fails the 1e-5).
- async_weight with weight_reduce 'mean' on a batch whose weak views'
  small superpixels are 40 an image on rank 0 and 6 on rank 1, so that
  the per-segment means of a small id differ between the ranks' images:
  a mean pooled over the ranks would move the weights and the loss.
- A padded crop (the last 4 rows and 3 columns of rank 1's images with
  id nseg, spmask False, label 255) for two steps: step 0's losses
  finite and equal, its gradient NaN in the same parameters as world
  1's (ROADMAP.md, open question 4); step 1 from the NaN weights, where
  the global NaN guard zeroes the terms on both ranks exactly where
  world 1 zeroes them.
- One pixel of rank 1's last image NaN with BN frozen, so that only that
  image's logits are NaN and rank 0's share of each term stays finite:
  the guard decided on the global term zeroes it on both ranks, as world
  1 zeroes its NaN term (the returned losses summed over the ranks equal
  world 1's; a guard on each rank's share would keep rank 0's).
- eval_al for eval_vistopone_within_multihot (a cosine-backed analysis
  method writing overlays) and for the probe on a 40x56 tree with 4
  labelled images, each rank taking whole images: the confusion matrix
  and the probe's counts exactly world 1's, the overlays world 1's byte
  for byte, each written once.
"""

import json
import os

import numpy as np
import pytest
import torch

from mulactseg_tpu_torch.engine.checkpoint import save_checkpoint
from mulactseg_tpu_torch.engine.train import CRITERIA
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.parallel import mesh
from mulactseg_tpu_torch.tools.cityscapes_tree import write_tree
from tests import torch_port_parallel_ranks as ranks
from tests.test_torch_port_model import jax_variables, twin_pair
from tests.torch_port_parallel_ranks import (
    B,
    HH,
    LEVELS,
    NSEG,
    SMALL,
    cfg_for,
    for_method,
    full_batch,
)

torch.set_num_threads(1)

NC = ranks.NC
# (case id, method, Config overrides): every CRITERIA entry but the
# fused lossdecomp and the CE criteria, which tests/test_torch_port_
# parallel.py holds; the ablation under each loss type and the options
# that change a criterion's path
CASES = [
    ("joint_predignore", "active_joint_multi_predignore", {}),
    ("joint", "active_joint_multi", {}),
    ("mclossablation2", "active_joint_multi_predignore_mclossablation2", {}),
    ("precise", "active_joint_multi_predignore_precise", {}),
    ("multice_precise", "active_joint_multi_predignore_multice_precise", {}),
    ("multient", "active_joint_multi_predignore_multient", {}),
    ("exclusivece", "active_joint_multi_predignore_exclusivece", {}),
    ("lossdecomp_rc", "active_joint_multi_lossdecomp_rc", {}),
    ("lossdecomp_topone", "active_joint_multi_lossdecomp_topone", {}),
    ("pwce", "active_pwce_multi_predignore", {"simw_temp_schedule": True}),
    ("top1plbl", "active_joint_multi_predignore_top1plbl",
     {"within_filtering": True, "plbl_th": 0.3, "dorampup": True}),
    ("mclossablation", "active_joint_multi_predignore_mclossablation", {}),
    ("lscale", "active_joint_multi_predignore_lscale", {}),
    ("wgroup", "active_joint_multi_predignore_wgroup", {}),
    ("ablation_rc", "active_joint_multi_ablation",
     {"loss_type": "rc_multi_ce"}),
    ("ablation_max", "active_joint_multi_ablation",
     {"loss_type": "max_multi_ce"}),
    ("ablation_rand", "active_joint_multi_ablation",
     {"loss_type": "rand_multi_ce"}),
    ("sequence", "active_joint_multi_predignore_sequence", {}),
    ("logprecision", "active_joint_multi_predignore_logprecision", {}),
    ("lossdecomp_unfused", "active_joint_multi_predignore_lossdecomp", {}),
    ("onlineplbl", "active_onlineplbl_multi_predignore", {}),
    ("onlinewplbl", "active_onlinewplbl_multi_predignore",
     {"weight_wo_proto": True}),
    ("onlinesimwplbl", "active_onlinesimwplbl_multi_predignore",
     {"th_wplbl": 0.3}),
    ("onlinewplblonly", "active_onlinewplblonly_multi_predignore", {}),
    ("onlineplbl_domc", "active_onlineplbl_multi_predignore_domc",
     {"dorampup": True, "lamparam": 0.3}),
    ("onlinesimwplbl_domc", "active_onlinesimwplbl_multi_predignore_domc",
     {}),
    ("hier", "active_joint_hier_multi", {}),
    ("hier_nocropsp", "active_joint_hier_multi", {"nocropsp": True}),
    ("hier_async", "active_joint_hier_multi_async", {}),
    ("hier_async_weight", "active_joint_hier_multi_async_weight", {}),
    ("hier_async_weight_mean", "active_joint_hier_multi_async_weight",
     {"weight_reduce": "mean"}),
    ("mseg", "active_joint_multi_predignore_mseg", {}),
]
IDS = [c[0] for c in CASES]
# K5 calls an image: 0 without a group term, 2 with two
K5_PER_IMAGE = {"multice_precise": 0, "wgroup": 2, "onlineplbl_domc": 2,
                "onlinesimwplbl_domc": 2, "hier_async_weight": 2,
                "mseg": len(LEVELS)}
PADDED = ["joint_predignore", "mclossablation2", "hier", "mseg"]
NAN_IMAGE = ["joint_predignore", "mclossablation2", "pwce", "sequence"]
ANALYSIS = "eval_vistopone_within_multihot"
PROBE = "active_joint_multi_analysis"


def padded(batch):
    """Rank 1's images (the last two rows) a padded crop: the last 4 rows
    and 3 columns with id nseg (each level's for mseg), spmask False and
    label 255, as the transforms pad them."""
    out = {k: v.copy() for k, v in batch.items()}
    rows = slice(B // 2, B)
    for key, value in (("spx", NSEG), ("spmask", False), ("labels", 255),
                       ("spx_small", SMALL)):
        out[key][rows, HH - 4:] = value
        out[key][rows, :, HH - 3:] = value
    for s, n in enumerate(LEVELS):
        for key, value in (("mseg_spx", n), ("mseg_spmask", False)):
            out[key][rows, s, HH - 4:] = value
            out[key][rows, s, :, HH - 3:] = value
    return out


def _tree(root, run, variables):
    """A 4 + 1 image 40x56 tree, the non-separable twin's checkpoint and a
    round-2 datalist labelling 15 of each image's 30 superpixels."""
    dl = write_tree(str(root), 4, 1, 40, 56, 30, seed=3,
                    num_classes=NC - 1, dataset="gta5")
    with open(os.path.join(dl, "train_seed30.txt")) as f:
        rows = [[str(root / p) for p in line.split("\t")]
                for line in f.read().splitlines()]
    rng = np.random.RandomState(0)
    sel = {r[2]: sorted(rng.choice(30, 15, replace=False).tolist())
           for r in rows}
    ck = str(run / "checkpoint02")
    model = ranks.port_twin(False)
    convert.load_variables(model, variables)
    run.mkdir()
    save_checkpoint(ck, model)
    (run / "datalist_02.json").write_text(json.dumps({
        "trg_label_im_idx": rows, "trg_pool_im_idx": [],
        "trg_label_suppix": sel, "trg_pool_suppix": {}}))

    def argv(out, method, *extra):
        return ["-p", str(out), "--data_root", str(root), "--datalist_dir",
                dl, "--dataset", "gta5", "--label_encoding", "cityscapes",
                "--nseg", "30", "--dtype", "float32", "--num_workers", "0",
                "--val_num_workers", "0", "--init_checkpoint", ck,
                "--resume_checkpoint", ck, "--init_iteration", "2",
                "--datalist_path", str(run / "datalist_02.json"),
                "--or_labeling", "--trim_multihot_boundary",
                "--trim_kernel_size", "5", "--dontlog", "--method", method,
                *extra]

    return lambda out: [
        argv(out, ANALYSIS, "--num_classes", str(NC - 1)),
        # the probe's model has num_classes outputs: the twin's NC
        argv(out, PROBE, "--num_classes", str(NC), "--train_batch_size",
             "2", "--crop_size", "24", "24")]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dpc")
    v = jax_variables(twin_pair(separable=True)[1], 7)
    rng = np.random.RandomState(21)
    batch = full_batch(rng)
    mean_batch = full_batch(rng, weak_small=(40, 6))
    steps = [(c, cfg_for(m, o), [for_method(batch, m)])
             for c, m, o in CASES]
    steps.append(("segment_means", cfg_for(
        "active_joint_hier_multi_async_weight", {"weight_reduce": "mean"}),
        [for_method(mean_batch, "active_joint_hier_multi_async_weight")]))
    pad = padded(batch)
    for c in PADDED:
        m = dict((k, mm) for k, mm, _ in CASES)[c]
        steps.append((f"padded_{c}", cfg_for(m, {}),
                      [for_method(pad, m)] * 2))
    nan = dict(batch, images=batch["images"].copy())
    nan["images"][B - 1, :, 5, 7] = np.nan
    for c in NAN_IMAGE:
        m = dict((k, mm) for k, mm, _ in CASES)[c]
        steps.append((f"nan_{c}", cfg_for(m, {}, freeze_bn=True),
                      [for_method(nan, m)]))
    argvs = _tree(tmp / "data", tmp / "run",
                  jax_variables(twin_pair(separable=False)[1], 7))
    two = mesh.spawn(ranks.run_all, 2, "gloo", "cpu", [
        ("steps", "criteria_steps", (("twin", v), steps)),
        ("evals", "eval_al_runs", (argvs(tmp / "w2"),))], timeout=240)
    one = ranks.run_all([("steps", "criteria_steps", (("twin", v), steps)),
                         ("evals", "eval_al_runs", (argvs(tmp / "w1"),))])
    return {"tmp": tmp, "two": two, "one": one, "mean_batch": mean_batch}


def _rel(got, want):
    d = sum(np.sum((got[k].astype(np.float64) - w) ** 2)
            for k, w in want.items())
    return np.sqrt(d / sum(np.sum(w.astype(np.float64) ** 2)
                           for w in want.values()))


def check_step0(two, one, name):
    want = one["steps"][name]
    assert want["losses"][0]["train_loss"] > 0.0
    grads = two[0]["steps"][name]["grads"]
    assert grads.keys() == want["grads"].keys()
    err = _rel(grads, want["grads"])
    assert err < 1e-4, (name, err)
    # each rank's loss is its share of world 1's
    np.testing.assert_allclose(sum(res["steps"][name]["totals"][0]
                                   for res in two), want["totals"][0],
                               rtol=1e-5, atol=1e-7, err_msg=name)
    for res in two:
        got = res["steps"][name]
        assert got["losses"][0].keys() == want["losses"][0].keys()
        for k, w in want["losses"][0].items():
            np.testing.assert_allclose(got["losses"][0][k], w, rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name} {k}")
        # both ranks step on the same summed gradient
        assert got["grad_sq"] == two[0]["steps"][name]["grad_sq"]
    return err


@pytest.mark.parametrize("name", IDS)
def test_step0_world2_matches_world1(case, name):
    check_step0(case["two"], case["one"], name)
    k5 = [res["steps"][name]["k5"] for res in case["two"]]
    per_image = K5_PER_IMAGE.get(name, 1)
    assert k5 == [per_image * B // 2] * 2
    assert sum(k5) == case["one"]["steps"][name]["k5"]


def test_every_criterion_is_covered():
    assert {m for _, m, _ in CASES} | {
        "active_predignore", "active", "active_slide",
        "active_joint_multi_lossdecomp"} == set(CRITERIA)


def test_hier_segment_means_stay_per_image(case):
    """weight_reduce 'mean' divides each small superpixel's probability
    sum by its size in its own image; here the same small ids cover
    ~36-pixel cells on rank 0's weak views and ~240-pixel ones on rank
    1's, so pooling the means over the ranks would change them."""
    small = case["mean_batch"]["spx_small_weak"]
    sizes = [np.bincount(small[b].ravel(), minlength=40)[:6].mean()
             for b in range(B)]
    assert min(sizes[2:]) > 2.5 * max(sizes[:2])
    check_step0(case["two"], case["one"], "segment_means")


@pytest.mark.parametrize("name", PADDED)
def test_padded_crop_nan_guard_world2_as_world1(case, name):
    key = f"padded_{name}"
    want = case["one"]["steps"][key]
    # step 0: finite losses, a NaN gradient (the padded pixels' NaN target
    # rows), so step 1 runs from NaN weights: its terms are NaN, and the
    # guards zero what the criterion returns (and, for the joint
    # criterion's per-term guards, the logged terms)
    assert all(np.isfinite(v) for v in want["losses"][0].values())
    assert not all(want["finite"].values())
    assert want["totals"][1] == 0.0
    assert all(w == 0.0 or np.isnan(w) for w in want["losses"][1].values())
    if name == "joint_predignore":
        assert set(want["losses"][1].values()) == {0.0}
    np.testing.assert_allclose(sum(res["steps"][key]["totals"][0]
                                   for res in case["two"]),
                               want["totals"][0], rtol=1e-5)
    for res in case["two"]:
        got = res["steps"][key]
        assert got["finite"] == want["finite"]
        assert got["totals"][1] == 0.0
        for i in range(2):
            assert got["losses"][i].keys() == want["losses"][i].keys()
            for k, w in want["losses"][i].items():
                # NaN where world 1 logs NaN, 0 where its guard zeroed
                np.testing.assert_allclose(got["losses"][i][k], w,
                                           rtol=1e-5, err_msg=f"{key} {k}")


@pytest.mark.parametrize("name", NAN_IMAGE)
def test_nan_on_one_rank_is_zeroed_on_both(case, name):
    """With BN frozen the NaN pixel spoils only its own image, so rank 0's
    share of each term is finite: the guard must read the global term."""
    key = f"nan_{name}"
    one = case["one"]["steps"][key]
    want = one["losses"][0]
    # world 1's guard fired: a logged term or the returned loss is 0 (the
    # group terms stay finite: a NaN pixel never wins a segment's max)
    assert 0.0 in want.values() or one["totals"] == [0.0]
    np.testing.assert_allclose(sum(res["steps"][key]["totals"][0]
                                   for res in case["two"]),
                               one["totals"][0], rtol=1e-5, atol=1e-7)
    for res in case["two"]:
        got = res["steps"][key]
        assert np.isfinite(got["totals"][0])
        assert got["losses"][0].keys() == want.keys()
        for k, w in want.items():
            # rank 0's share of a zeroed term is finite, and zeroed too
            np.testing.assert_allclose(got["losses"][0][k], w, rtol=1e-5,
                                       err_msg=f"{key} {k}")
        assert got["finite"] == one["finite"]


def test_analysis_eval_world2_equals_world1(case):
    tmp, one = case["tmp"], case["one"]["evals"][0]
    vis = f"vis_{ANALYSIS}_02"
    names = sorted(os.listdir(tmp / "w1" / vis))
    assert len(names) == 4 and one["k5"] == 4
    assert one["result"]["confusion"].sum() > 0
    written = []
    for res in case["two"]:
        got = res["evals"][0]
        np.testing.assert_array_equal(got["result"]["confusion"],
                                      one["result"]["confusion"])
        assert got["result"]["miou"] == one["result"]["miou"]
        assert got["k5"] == 2 and len(got["overlays"]) == 2
        written += got["overlays"]
    # each overlay written once, by the rank that scored its image
    assert sorted(os.path.basename(p) for p in written) == names
    assert sorted(os.listdir(tmp / "w2" / vis)) == names
    for n in names:
        assert (tmp / "w2" / vis / n).read_bytes() == \
            (tmp / "w1" / vis / n).read_bytes()


def test_probe_world2_counts_equal_world1(case):
    one = case["one"]["evals"][1]["result"]
    assert one["n_total"] > 0 and case["one"]["evals"][1]["k5"] == 4
    for res in case["two"]:
        got = res["evals"][1]
        assert got["k5"] == 2
        for k in ("ncorr_cls", "n_cls"):
            np.testing.assert_array_equal(got["result"][k], one[k])
        for k in ("ncorr_total", "n_total", "acc_total"):
            assert got["result"][k] == one[k]
