"""The loader arms the hierarchy, async, mseg and dominant criteria read,
against the JAX package's, on a small tools/cityscapes_tree.py tree with
extra superpixel granularities (12 and 60 beside nseg 30) and the
dominant labels:

- RegionDatasetOr's options, item by item over two passes (so the
  transforms' streams advance alike), key by key and bitwise (images
  transposed): async views (weak view resized to 24x40, and the asyncv2
  flip), load_smaller_spx, oracle labels and woignore, or_plbl's saved
  maps, each research multi-hot rewrite (research_filters, the sampled
  ones from the same seed);
- the research rewrites themselves on random sizes, bitwise;
- RegionDatasetDominant: predignore, withgt and oracle (full
  supervision), the known_ignore and prob_dominant datalist swaps;
- the dominant mode of tools/label_assignment against the JAX tool's PNGs;
- RegionDatasetMseg's pool and label items, and MsegRegionActiveSet's
  selection and datalist JSON files byte for byte, and their reload;
- the SYNTHIA label reader and table on 16-bit greyscale, palette and
  8-bit RGB files, and the validation dataset the CLI builds for it;
- build_active_datasets dispatching every loader branch as the JAX
  package's does (the same dataset class and options), the statistics
  loaders too (test_torch_port_stats.py holds their items).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from mulactseg_tpu.active.mseg_active_set import (
    MsegRegionActiveSet as JaxMsegSet,
)
from mulactseg_tpu.cli import common as jax_common
from mulactseg_tpu.config import Config as JaxConfig
from mulactseg_tpu.data import datasets as jd
from mulactseg_tpu.data import research_filters as jrf
from mulactseg_tpu.data import transforms as jtf
from mulactseg_tpu.tools import label_assignment as jax_la
from mulactseg_tpu_torch.active.mseg_active_set import MsegRegionActiveSet
from mulactseg_tpu_torch.cli import common
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.data import datasets as pd
from mulactseg_tpu_torch.data import research_filters as rf
from mulactseg_tpu_torch.data import transforms as ptf
from mulactseg_tpu_torch.data.loader import collate
from mulactseg_tpu_torch.tools import label_assignment
from mulactseg_tpu_torch.tools.cityscapes_tree import write_tree
from mulactseg_tpu_torch.utils.png import read_gray8, write_gray8

torch.set_num_threads(1)

NSEG, SMALL, COARSE, CROP = 30, 60, 12, (24, 32)
IMAGE_HW, WEAK = (40, 56), (24, 40)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("arms")
    dl = write_tree(str(root), 4, 2, *IMAGE_HW, NSEG, seed=2,
                    extra_nseg=(COARSE, SMALL), dominant=True)
    return str(root), dl


def _cfgs(tree, **kw):
    root, dl = tree
    base = dict(data_root=root, datalist_dir=dl, nseg=NSEG, crop_size=CROP,
                dtype="float32", small_nseg=SMALL, multihot_filter_size=20,
                multihot_filter_ratio=0.2)
    base.update(kw)
    return Config(**base).derive_paths(), JaxConfig(**base).derive_paths()


def _same_item(got, want):
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for k, w in want.items():
        g = got[k]
        if k == "fnames":
            assert g == w
            continue
        w = np.asarray(w)
        if k in ("images", "images_weak"):
            w = w.transpose(2, 0, 1)
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


def _select(port, jax, seed, n=12):
    rng = np.random.RandomState(seed)
    for key in list(port.suppix):
        sel = sorted(rng.choice(port.suppix[key], n, replace=False).tolist())
        port.suppix[key], jax.suppix[key] = sel, list(sel)


def _passes(port, jax):
    for _ in range(2):
        for i in range(len(port)):
            _same_item(port[i], jax[i])
    return port[0]


OR_CASES = [
    ("async", "rescale_769_multi_notrg",
     dict(async_views=True, weak_size=WEAK, load_smaller_spx=True)),
    ("asyncv2_ignore", "rescale_769_multi_ignore_notrg",
     dict(async_views=True, weak_size=WEAK, async_weak_hflip=True,
          ignore_gt_in_spmask=True)),
    ("smaller_spx", "rescale_769_multi_notrg", dict(load_smaller_spx=True)),
    ("oracle", "rescale_769_multi_ignore_notrg", dict(oracle_labels=True)),
    ("oracle_woignore", "rescale_769_multi_ignore_notrg",
     dict(oracle_labels=True, oracle_keep_ignore=True)),
    ("or_plbl", "rescale_769_multi_ignore_notrg", dict(plbl_dir="PLBL")),
] + [(name, "rescale_769_multi_notrg", dict(multihot_transform=name))
     for name in ("tinyfilter", "tinyfilter_recommend", "ratiofilter",
                  "ratiosample", "dominantsample", "toponebase")]


@pytest.mark.parametrize("case,tf_name,kw", OR_CASES,
                         ids=[c[0] for c in OR_CASES])
def test_region_dataset_or_options_match_jax(tree, tmp_path, case, tf_name,
                                             kw):
    cfg, jcfg = _cfgs(tree)
    if kw.get("plbl_dir"):
        rng = np.random.RandomState(4)
        for name in os.listdir(os.path.join(tree[0], "gtFine", "train",
                                            "synth")):
            write_gray8(str(tmp_path / name),
                        rng.randint(0, 20, IMAGE_HW).astype(np.uint8))
        kw = dict(kw, plbl_dir=str(tmp_path))
    port = pd.RegionDatasetOr(cfg, cfg.trg_datalist, cfg.region_dict,
                              "active-label", ptf.get_train_transform(
                                  tf_name, cfg, seed=5), **kw)
    jax = jd.RegionDatasetOr(jcfg, jcfg.trg_datalist, jcfg.region_dict,
                             "active-label", jtf.get_train_transform(
                                 tf_name, jcfg, seed=5), **kw)
    np.testing.assert_array_equal(port.multi_hot_cls, jax.multi_hot_cls)
    _select(port, jax, 0)
    got = _passes(port, jax)
    if "multihot_transform" in kw:
        assert not np.array_equal(port.multi_hot_cls, np.load(
            pd.multi_hot_paths(cfg)["multi_hot_cls"]))
    if kw.get("async_views"):
        assert got["images_weak"].shape == (3,) + WEAK
    if kw.get("load_smaller_spx"):
        assert got["spx_small"].max() >= NSEG  # the finer map's ids


def test_research_rewrites_match_jax():
    rng = np.random.RandomState(6)
    sizes = rng.randint(0, 40, (3, 25, 8)).astype(np.int32)
    sizes[:, ::7] = -1  # absent superpixels
    mh = (sizes > 0).astype(np.uint8)
    cfg = Config(multihot_filter_size=10, multihot_filter_ratio=0.2, seed=3)
    for name in ("tinyfilter", "tinyfilter_recommend", "ratiofilter",
                 "ratiosample", "dominantsample", "toponebase"):
        got = rf.apply_multihot_transform(name, mh.copy(), sizes, cfg,
                                          seed=3)
        want = jrf.apply_multihot_transform(name, mh.copy(), sizes, cfg,
                                            seed=3)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=name)
    with pytest.raises(KeyError):
        rf.apply_multihot_transform("nofilter", mh, sizes, cfg)


def test_dominant_labels_match_the_jax_tool(tree, tmp_path):
    root, dl = tree
    datalist = os.path.join(dl, f"train_seed{NSEG}.txt")
    for vote in (False, True):
        flags = ["--generate_ignore"] if vote else []
        argv = ["--mode", "dominant", "--datalist", datalist, "--data_root",
                root, "--nseg", str(NSEG)] + flags
        label_assignment.main(argv + ["--save_data_dir",
                                      str(tmp_path / f"port{vote}")])
        jax_la.main(argv + ["--save_data_dir", str(tmp_path / f"jax{vote}")])
        names = sorted(os.listdir(tmp_path / f"jax{vote}"))
        assert names == sorted(os.listdir(tmp_path / f"port{vote}"))
        assert len(names) == 4
        for n in names:
            got = read_gray8(str(tmp_path / f"port{vote}" / n))
            want = np.asarray(Image.open(tmp_path / f"jax{vote}" / n))
            np.testing.assert_array_equal(got, want)
            sub = "gtFine_dominant_ignore" if vote else "gtFine_dominant"
            np.testing.assert_array_equal(got, read_gray8(os.path.join(
                root, f"superpixel_seed/cityscapes/seeds_{NSEG}/train",
                sub, n)))  # the tree's own files are these


DOMINANT_CASES = [
    ("plain", {}, {}),
    ("predignore", dict(pred_ignore=True), {}),
    ("withgt_predignore", dict(pred_ignore=True, with_gt=True), {}),
    ("oracle_known_ignore", dict(full_supervision=True),
     dict(known_ignore=True)),
    ("raw_labels", {}, dict(dominant_labeling=False, known_ignore=True)),
]


@pytest.mark.parametrize("case,kw,over", DOMINANT_CASES,
                         ids=[c[0] for c in DOMINANT_CASES])
def test_region_dataset_dominant_matches_jax(tree, case, kw, over):
    root, dl = tree
    cfg, jcfg = _cfgs(tree, **{"dominant_labeling": True, **over},
                      trg_datalist=os.path.join(
                          dl, f"train_seed{NSEG}_dominant_labels.txt"))
    pads = [255, NSEG] + ([255] if kw.get("with_gt") else [])
    tfs = [m.PairedTransform(scale_range=(0.5, 2.0), crop_size=CROP,
                             pad_values=pads, hflip=True, seed=7)
           for m in (ptf, jtf)]
    port = pd.RegionDatasetDominant(cfg, cfg.trg_datalist, cfg.region_dict,
                                    "active-label", tfs[0], **kw)
    jax = jd.RegionDatasetDominant(jcfg, jcfg.trg_datalist, jcfg.region_dict,
                                   "active-label", tfs[1], **kw)
    assert port.im_idx == jax.im_idx
    assert len(port) == (4 if kw.get("full_supervision") else 0)
    if not port.im_idx:  # the active set fills the labelled set
        pool = pd.RegionDatasetDominant(cfg, cfg.trg_datalist,
                                        cfg.region_dict, "active-ulabel")
        port.im_idx, jax.im_idx = [list(r) for r in pool.im_idx], \
            [list(r) for r in pool.im_idx]
        port.suppix, jax.suppix = dict(pool.suppix), dict(pool.suppix)
    assert ("gtFine_dominant_ignore" in port.im_idx[0][1]) == (
        not over.get("known_ignore"))
    _select(port, jax, 1)
    got = _passes(port, jax)
    assert got["images"].shape[1:] == CROP and ("target" in got) == (
        "withgt" in case)
    pool, jpool = (m.RegionDatasetDominant(c, c.trg_datalist, c.region_dict,
                                           "active-ulabel")
                   for m, c in ((pd, cfg), (jd, jcfg)))
    _same_item(pool[1], jpool[1])


def test_dominant_datalist_swaps_match_jax(tree):
    """prob_dominant names the sampled labels, known_ignore keeps the
    plain ones, as the JAX loader's paths."""
    root, dl = tree
    for over in (dict(prob_dominant=True), dict(known_ignore=True), {}):
        cfg, jcfg = _cfgs(tree, dominant_labeling=True, **over)
        port, jax = (m.RegionDatasetDominant(
            c, os.path.join(dl, f"train_seed{NSEG}_dominant_labels.txt"),
            c.region_dict, "active-ulabel") for m, c in ((pd, cfg),
                                                           (jd, jcfg)))
        assert port.im_idx == jax.im_idx and port.suppix == jax.suppix
        assert ("_ignore_sample" in port.im_idx[0][1]) == bool(over.get(
            "prob_dominant"))


def _mseg_pair(tree):
    root, dl = tree
    cfg, jcfg = _cfgs(tree, nseg_list=(COARSE, NSEG),
                      method="active_joint_multi_predignore_mseg",
                      loader="mseg_region_cityscapes_or_tensor",
                      region_dict=os.path.join(dl, f"train_seed{NSEG}.dict"))
    lists = {n: os.path.join(dl, f"train_seed{n}.txt")
             for n in (COARSE, NSEG)}
    dicts = {n: os.path.join(dl, f"train_seed{n}.dict")
             for n in (COARSE, NSEG)}
    tfs = [m.PairedTransform(scale_range=(0.5, 2.0), crop_size=CROP,
                             pad_values=[COARSE, NSEG], hflip=True, seed=8)
           for m in (ptf, jtf)]
    out = []
    for mod, c, tf, set_cls in ((pd, cfg, tfs[0], MsegRegionActiveSet),
                                (jd, jcfg, tfs[1], JaxMsegSet)):
        pool = mod.RegionDatasetMseg(c, lists, dicts, "active-ulabel")
        label = mod.RegionDatasetMseg(c, lists, dicts, "active-label", tf,
                                      multi_hot_by_nseg=pool.mseg_mh_cls)
        active = set_cls(c, pool, label, root=root)
        # the tree's layout in the active set's path templates
        active.lbl_tpl = "gtFine/train/synth/{1}_gtFine_labelIds.png"
        active.spx_tpl = "superpixels/seeds_{}/train/synth/{}.pkl"
        out.append(active)
    return out


def test_mseg_datasets_and_active_set_match_jax(tree, tmp_path):
    port, jax = _mseg_pair(tree)
    for a, run in ((port, "port"), (jax, "jax")):
        a.cfg.model_save_dir = str(tmp_path / run)
    pp, jp = port.trg_pool_dataset, jax.trg_pool_dataset
    assert pp.im_idx == jp.im_idx and len(pp) == 4
    assert pp.suppix == jp.suppix
    _same_item(pp[2], jp[2])
    fids = [os.path.basename(p[0])[:-len("_leftImg8bit.png")]
            for p in pp.im_idx]
    rows = [(0.9, f"{COARSE}/{fids[0]}", 1), (0.8, f"{NSEG}/{fids[0]}", 3),
            (0.7, f"{COARSE}/{fids[1]}", 2), (0.6, f"{NSEG}/{fids[2]}", 5),
            (0.5, f"{NSEG}/{fids[2]}", 6)]
    for a in (port, jax):
        assert a.expand_training_set(rows, 10, "test") == 5
        a.dump_datalist()
    for name in ("test_selection_00.json", "datalist_00.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    pl, jl = port.trg_label_dataset, jax.trg_label_dataset
    assert len(pl) == 3 and len(pl.im_idx[0][1]) == 2
    got = _passes(pl, jl)
    assert got["nseg_lbl"].all() and got["mseg_spx"].shape == (2,) + CROP
    batch = collate([pl[i] for i in range(3)])
    assert batch["mseg_spmask"].shape == (3, 2) + CROP
    assert not batch["nseg_lbl"][1:].all()  # images 1 and 2: one level
    # a reload restores the state
    again, _ = _mseg_pair(tree)
    again.cfg.model_save_dir = str(tmp_path / "port")
    again.load_datalist()
    assert again.trg_label_dataset.im_idx == pl.im_idx
    assert again.trg_pool_dataset.suppix == pp.suppix
    assert again.get_trainset() is again.trg_label_dataset


def test_synthia_labels_match_jax(tmp_path):
    rng = np.random.RandomState(9)
    ids16 = rng.randint(0, 300, (12, 10)).astype(np.uint16)
    Image.fromarray(ids16).save(tmp_path / "grey16.png")
    ids8 = rng.randint(0, 40, (12, 10, 3)).astype(np.uint8)
    Image.fromarray(ids8).save(tmp_path / "rgb8.png")
    pal = Image.fromarray(rng.randint(0, 40, (12, 10)).astype(np.uint8),
                          "P")
    pal.putpalette(list(range(256)) * 3)
    pal.save(tmp_path / "pal.png")
    for name in ("grey16.png", "rgb8.png", "pal.png"):
        got = pd.open_label_synthia(str(tmp_path / name))
        want = jd.open_label_synthia(str(tmp_path / name))
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(pd.encode_synthia(got),
                                      jd.encode_synthia(want))
    raw = np.arange(-2, 300).reshape(2, -1)
    np.testing.assert_array_equal(pd.encode_synthia(raw),
                                  jd.encode_synthia(raw))


def test_synthia_validation_set_matches_jax(tree, tmp_path):
    """_build_val_dataset's SYNTHIA branch: its table and reader over a
    val list of 16-bit label files."""
    root, dl = tree
    rng = np.random.RandomState(10)
    rows = []
    with open(os.path.join(dl, "val.txt")) as f:
        for line in f.read().splitlines():
            img, lbl = line.split("\t")
            out = lbl.replace(".png", "_synthia.png")
            Image.fromarray(rng.randint(0, 30, IMAGE_HW).astype(
                np.uint16)).save(os.path.join(root, out))
            rows.append(f"{img}\t{out}\n")
    val_list = tmp_path / "val_synthia.txt"
    val_list.write_text("".join(rows))
    cfg, jcfg = _cfgs(tree, dataset="synthia", val_datalist=str(val_list))
    port = common._build_val_dataset(cfg, pd.encode_cityscapes)
    jax = jax_common._build_val_dataset(jcfg, jd.encode_cityscapes)
    assert port.label_opener is pd.open_label_synthia
    for i in range(2):
        _same_item(port[i], jax[i])


DISPATCH = [
    dict(loader="region_cityscapes_or_tensor"),
    dict(loader="region_cityscapes_or_tensor_ignore_async",
         method="active_joint_hier_multi_async_weight"),
    dict(loader="region_cityscapes_or_tensor_ignore_asyncv2",
         method="active_joint_hier_multi_async"),
    dict(loader="region_cityscapes_or_tensor", load_smaller_spx=True),
    dict(loader="region_cityscapes_or_tensor_ratiosample_gt"),
    dict(loader="eval_region_cityscapes_ratiofilt_all"),
    dict(loader="region_cityscapes_or_oracle_woignore"),
    dict(loader="region_cityscapes_or_plbl", resume_checkpoint="run/ckpt",
         plbl_type="cosprop_includeonehot", init_iteration=2),
    dict(loader="region_cityscapes_predignore", or_labeling=False,
         dominant_labeling=True, known_ignore=True),
    dict(loader="region_cityscapes_withgt", or_labeling=False,
         method="active_predignore", dominant_labeling=True),
    dict(loader="region_cityscapes_oracle", or_labeling=False,
         dominant_labeling=True),
]
_OPTIONS = ("ignore_gt_in_spmask", "load_smaller_spx", "async_views",
            "weak_size", "oracle_labels", "oracle_keep_ignore", "plbl_dir",
            "pred_ignore", "with_gt", "load_gt")


@pytest.mark.parametrize("kw", DISPATCH, ids=[
    "-".join(str(v) for v in d.values()) for d in DISPATCH])
def test_build_active_datasets_dispatches_as_jax(tree, kw):
    root, dl = tree
    if kw.get("dominant_labeling"):
        kw = dict(kw, trg_datalist=os.path.join(
            dl, f"train_seed{NSEG}_dominant_labels.txt"))
    cfg, jcfg = _cfgs(tree, **kw)
    active, val = common.build_active_datasets(cfg)
    jactive, jval = jax_common.build_active_datasets(jcfg)
    for got, want in ((active.trg_label_dataset, jactive.trg_label_dataset),
                      (active.trg_pool_dataset, jactive.trg_pool_dataset),
                      (val, jval)):
        assert type(got).__name__ == type(want).__name__
        for name in _OPTIONS:
            assert getattr(got, name, None) == getattr(want, name, None), \
                name
        assert got.im_idx == want.im_idx
        assert (got.transform is None) == (want.transform is None)
        if got.transform is not None:
            assert got.transform.pad_values == want.transform.pad_values
    if hasattr(active.trg_label_dataset, "multi_hot_cls"):
        np.testing.assert_array_equal(active.trg_label_dataset.multi_hot_cls,
                                      jactive.trg_label_dataset.multi_hot_cls)


def test_mseg_arm_dispatches_as_jax(tree):
    root, dl = tree
    cfg, jcfg = _cfgs(tree, nseg=NSEG, nseg_list=(COARSE, NSEG),
                      loader="mseg_region_cityscapes_or_tensor",
                      region_dict=os.path.join(dl, f"train_seed{NSEG}.dict"))
    active, _ = common.build_active_datasets(cfg)
    jactive, _ = jax_common.build_active_datasets(jcfg)
    assert type(active).__name__ == "MsegRegionActiveSet"
    assert active.trg_pool_dataset.im_idx == jactive.trg_pool_dataset.im_idx
    assert active.trg_label_dataset.transform.pad_values == [COARSE, NSEG]


@pytest.mark.parametrize("loader", ["region_cityscapes_count_all",
                                    "region_cityscapes_visualize_minor",
                                    "region_cityscapes_dom_w_gt",
                                    "region_cityscapes_dominant_all_sample"])
def test_only_the_analysis_loaders_raise(tree, loader):
    """The statistics loaders, named with or_labeling unset, wrap the
    dominant arm's labelled set as the JAX package's do."""
    cfg, jcfg = _cfgs(tree, loader=loader, or_labeling=False)
    got = common.build_active_datasets(cfg)[0].trg_label_dataset
    want = jax_common.build_active_datasets(jcfg)[0].trg_label_dataset
    assert type(got).__name__ == type(want).__name__ == "RegionStatsDataset"
    assert type(got.base).__name__ == type(want.base).__name__ == \
        "RegionDatasetDominant"
    assert got.mode == want.mode and len(got) == len(want) == 0
