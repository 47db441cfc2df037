"""The port's statistics loaders (mulactseg_tpu_torch/data/stats.py) and
their dispatch in cli/common.py, against the JAX package's
data/stats.py, on the tree of test_torch_port_loader_arms.py (40x56,
nseg 30, dominant labels):

- superpixel_count_stats, superpixel_composition (with and without the
  boundary trim) and sample_dominant_map (the same RandomState seed, also
  with generate_ignore): exactly.
- RegionStatsDataset in each mode over the Or arm's and the dominant
  arm's labelled set, with and without a train transform, item by item
  over two passes (so the streams advance alike), key by key and bitwise
  (images transposed); dominant_sample from the same seed equals JAX's
  sequential items (num_workers=0) when the port builds them in two
  worker processes, since the parent draws the crops and the Gumbel noise
  in item order.
- build_active_datasets dispatching each statistics loader over the arm
  the flags pick, with pred_ignore from the method or the resume
  checkpoint, as the JAX package's.
"""

import os

import numpy as np
import pytest
import torch

from mulactseg_tpu.cli import common as jax_common
from mulactseg_tpu.data import stats as jax_stats
from mulactseg_tpu_torch.cli import common
from mulactseg_tpu_torch.data import stats
from mulactseg_tpu_torch.data.loader import DataProvider
from mulactseg_tpu_torch.data.synthetic import grid_superpixels
from tests.test_torch_port_loader_arms import (  # noqa: F401
    NSEG,
    _cfgs,
    _same_item,
    _select,
    tree,
)

torch.set_num_threads(1)

H = W = 32
S, C = 11, 6


def _fixture(seed=0):
    rng = np.random.RandomState(seed)
    spx = grid_superpixels(H, W, S)
    gt = rng.randint(0, C, (H, W)).astype(np.int64)
    gt[rng.rand(H, W) < 0.1] = 255
    gt[spx == 3] = 255  # an all-ignore superpixel
    return gt, spx, [0, 2, 3, 5, 7, 10]


def test_stats_functions_match_jax():
    for seed in range(3):
        gt, spx, selected = _fixture(seed)
        for got, want in zip(
                stats.superpixel_count_stats(gt, spx, S, C, selected),
                jax_stats.superpixel_count_stats(gt, spx, S, C, selected)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        for trim in (False, True):
            for got, want in zip(
                    stats.superpixel_composition(gt, spx, S, C, selected,
                                                 ignore_boundaries=trim),
                    jax_stats.superpixel_composition(
                        gt, spx, S, C, selected, ignore_boundaries=trim)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
        for gen_ignore in (False, True):
            got = stats.sample_dominant_map(
                gt, spx, S, C, selected, np.random.RandomState(seed),
                gen_ignore)
            want = jax_stats.sample_dominant_map(
                gt, spx, S, C, selected, np.random.RandomState(seed),
                gen_ignore)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert stats.LOADER_MODES == jax_stats.LOADER_MODES
    for name in ("region_cityscapes_count_all", "region_cityscapes_dom_w_gt",
                 "region_cityscapes_or_tensor"):
        assert stats.stats_mode_for_loader(name) == \
            jax_stats.stats_mode_for_loader(name)


def _same_stats_item(got, want):
    if "superpixel_info" in want:
        for g, w in zip(got.pop("superpixel_info"),
                        want.pop("superpixel_info")):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    if "fname" in want:
        assert got.pop("fname") == want.pop("fname")
    _same_item(got, want)


ARMS = [
    # (loader, Config fields of the arm)
    ("region_cityscapes_or_tensor_count_all", {}),
    ("region_cityscapes_or_tensor_visualize_minor", {}),
    ("region_cityscapes_or_tensor_dom_w_gt", {}),
    ("region_cityscapes_or_tensor_dominant_all_sample", {}),
    ("region_cityscapes_dom_w_gt", {"or_labeling": False,
                                    "dominant_labeling": True}),
    ("region_cityscapes_dominant_all_sample",
     {"or_labeling": False, "dominant_labeling": True}),
]
# the dominant arm reads the datalist of the dominant label files
DOMINANT_LIST = f"train_seed{NSEG}_dominant_labels.txt"


@pytest.mark.parametrize("loader,kw", ARMS, ids=[a[0] for a in ARMS])
def test_stats_loaders_match_jax(tree, loader, kw):
    if not kw.get("or_labeling", True):
        kw = dict(kw, trg_datalist=os.path.join(tree[1], DOMINANT_LIST))
    cfg, jcfg = _cfgs(tree, loader=loader, method="active_predignore", **kw)
    port = common.build_active_datasets(cfg)[0]
    jax = jax_common.build_active_datasets(jcfg)[0]
    label, jlabel = port.trg_label_dataset, jax.trg_label_dataset
    assert type(label).__name__ == type(jlabel).__name__ == \
        "RegionStatsDataset"
    assert label.mode == jlabel.mode == stats.stats_mode_for_loader(loader)
    assert label.pred_ignore and jlabel.pred_ignore
    # the labelled set: every pool image, 12 superpixels each
    pool = port.trg_pool_dataset
    label.im_idx = [list(k) for k in pool.im_idx]
    jlabel.im_idx = [list(k) for k in pool.im_idx]
    label.suppix = {k[2]: list(pool.suppix[k[2]]) for k in pool.im_idx}
    jlabel.suppix = {k[2]: list(pool.suppix[k[2]]) for k in pool.im_idx}
    _select(label, jlabel, 1)
    for _ in range(2):
        for i in range(len(label)):
            _same_stats_item(label[i], jlabel[i])
    if label.mode in ("dom_w_gt", "dominant_sample"):
        assert label.transform is not None
        assert label[0]["images"].shape == (3, 24, 32)


@pytest.mark.parametrize("with_transform", [False, True])
def test_dominant_sample_on_workers_matches_jax_in_order(tree,
                                                         with_transform):
    loader = "region_cityscapes_or_tensor_dominant_all_sample"
    cfg, jcfg = _cfgs(tree, loader=loader)
    port = common.build_active_datasets(cfg)[0]
    jax = jax_common.build_active_datasets(jcfg)[0]
    pool = port.trg_pool_dataset
    ds, jds = port.trg_label_dataset, jax.trg_label_dataset
    for d in (ds, jds):
        d.im_idx = [list(k) for k in pool.im_idx]
        d.suppix = {k[2]: list(pool.suppix[k[2]]) for k in pool.im_idx}
        if not with_transform:
            d.transform = None
    want = [jds[i] for _ in range(2) for i in range(len(jds))]
    provider = DataProvider(ds, 1, shuffle=False, drop_last=False,
                            infinite=False, num_workers=2)
    try:
        got = [b for _ in range(2) for b in provider]
    finally:
        provider.close()
    assert len(got) == len(want) == 2 * len(pool)
    for g, w in zip(got, want):
        assert g["fnames"] == [w["fnames"]]
        np.testing.assert_array_equal(g["labels"][0], w["labels"])
        np.testing.assert_array_equal(
            g["images"][0], np.asarray(w["images"]).transpose(2, 0, 1))
    # the second pass draws new labels from the advancing stream
    n = len(pool)
    assert any(not np.array_equal(got[i]["labels"], got[i + n]["labels"])
               for i in range(n))


def test_pred_ignore_follows_method_and_checkpoint(tree):
    loader = "region_cityscapes_or_tensor_dom_w_gt"
    for over, want in (({"method": "active"}, False),
                       ({"method": "active_joint_multi_predignore"}, True),
                       ({"method": "active",
                         "resume_checkpoint": "/x/predignore/ck"}, True)):
        cfg, jcfg = _cfgs(tree, loader=loader, **over)
        got = common.build_active_datasets(cfg)[0].trg_label_dataset
        ref = jax_common.build_active_datasets(jcfg)[0].trg_label_dataset
        assert got.pred_ignore == ref.pred_ignore == want
        assert got.seed == ref.seed == cfg.seed
