"""The port's file loaders (mulactseg_tpu_torch/data/datasets.py, its PNG
readers, data/loader.py's worker processes) and offline tools
(tools/label_assignment.py, tools/gen_datalists.py) against the JAX
package's, on small trees in tmp_path (tools/cityscapes_tree.py: adaptive
filtered RGB PNGs, 8-bit label ids, .pkl superpixels, the multi-hot
tensors).

- Each item of RegionDatasetOr (both splits, the _ignore twin, uint8
  pool items), EvalRegionDatasetAll, RegionDatasetPlbl and ValDataset
  equals the JAX item key by key (target_bits included; images
  transposed), over two passes, so the transforms' streams advance alike.
- Superpixel maps in every format (8- and 16-bit PNG, .pkl, .npy) read
  as the JAX package reads them; the region dict in both formats.
- The multi-hot tensors and the datalist files equal the JAX tools'.
- A process loader with 2 workers gives the batches of the JAX loader
  with one worker, and over images with identical content no two items
  of an epoch share a crop (each item has its own draw); closed with
  batches in flight, it leaves no shared-memory block behind.
"""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from mulactseg_tpu.config import Config as JaxConfig
from mulactseg_tpu.data import datasets as jd
from mulactseg_tpu.data import transforms as jtf
from mulactseg_tpu.data.loader import DataProvider as JaxProvider
from mulactseg_tpu.tools import gen_datalists as jax_gen
from mulactseg_tpu.tools import label_assignment as jax_la
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.data import datasets as pd
from mulactseg_tpu_torch.data import transforms as ptf
from mulactseg_tpu_torch.data.loader import DataProvider, start_workers
from mulactseg_tpu_torch.tools import gen_datalists, label_assignment
from mulactseg_tpu_torch.tools.cityscapes_tree import write_tree
from mulactseg_tpu_torch.utils.png import read_gray, read_gray8, write_gray8

torch.set_num_threads(1)

NSEG, CROP = 30, (24, 32)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    dl = write_tree(str(root), 4, 2, 40, 56, NSEG, seed=1)
    return str(root), dl


def _cfgs(tree, **kw):
    root, dl = tree
    base = dict(data_root=root, datalist_dir=dl, nseg=NSEG, crop_size=CROP,
                dtype="float32")
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
        if k == "images":
            w = w.transpose(2, 0, 1)
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


def _select(port, jax, seed):
    rng = np.random.RandomState(seed)
    for key in list(port.suppix):
        sel = sorted(rng.choice(port.suppix[key], 12, replace=False).tolist())
        port.suppix[key], jax.suppix[key] = sel, list(sel)


def _or_pair(tree, split, loader, **kw):
    cfg, jcfg = _cfgs(tree, **kw)
    tf_name = ("rescale_769_multi_ignore_notrg" if "ignore" in loader
               else "rescale_769_multi_notrg")
    tfs = ((ptf.get_train_transform(tf_name, cfg, seed=5),
            jtf.get_train_transform(tf_name, jcfg, seed=5))
           if split == "active-label" else (None, None))
    ig = "ignore" in loader
    port = pd.RegionDatasetOr(cfg, cfg.trg_datalist, cfg.region_dict, split,
                              transform=tfs[0], ignore_gt_in_spmask=ig)
    jax = jd.RegionDatasetOr(jcfg, jcfg.trg_datalist, jcfg.region_dict,
                             split, transform=tfs[1], ignore_gt_in_spmask=ig)
    return port, jax


@pytest.mark.parametrize("split,loader,u8", [
    ("active-label", "region_cityscapes_or_tensor", False),
    ("active-label", "region_cityscapes_or_tensor_ignore", False),
    ("active-ulabel", "region_cityscapes_or_tensor", False),
    ("active-ulabel", "region_cityscapes_or_tensor", True),
])
def test_region_dataset_or_matches_jax(tree, split, loader, u8):
    port, jax = _or_pair(tree, split, loader, ship_uint8=u8)
    _select(port, jax, 0)
    assert port.id_to_index == jax.id_to_index
    np.testing.assert_array_equal(port.multi_hot_cls, jax.multi_hot_cls)
    for _ in range(2):
        for i in range(len(port)):
            got, want = port[i], jax[i]
            _same_item(got, want)
    if split == "active-label":
        assert "target_bits" in got and got["images"].shape[1:] == CROP
        assert ("labels" in got) == ("ignore" in loader)


@pytest.mark.parametrize("emit_u8", [False, True])
@pytest.mark.parametrize("remove_dominant,mask_unselected",
                         [(False, False), (True, True)])
def test_eval_region_dataset_all_matches_jax(tree, emit_u8, remove_dominant,
                                             mask_unselected):
    port_base, jax_base = _or_pair(tree, "active-label",
                                   "region_cityscapes_or_tensor")
    _select(port_base, jax_base, 1)
    for key in list(port_base.suppix)[1:2]:  # an image with none selected
        del port_base.suppix[key], jax_base.suppix[key]
    kw = dict(remove_dominant=remove_dominant,
              mask_unselected=mask_unselected, emit_u8=emit_u8)
    port = pd.EvalRegionDatasetAll(port_base.cfg, port_base,
                                   port_base.suppix, **kw)
    jax = jd.EvalRegionDatasetAll(jax_base.cfg, jax_base, jax_base.suppix,
                                  **kw)
    assert port.im_idx == jax.im_idx and len(port) == 3
    for i in range(len(port)):
        _same_item(port[i], jax[i])


@pytest.mark.parametrize("with_transform", [False, True])
def test_region_dataset_plbl_matches_jax(tree, tmp_path, with_transform):
    cfg, jcfg = _cfgs(tree)
    base, _ = _or_pair(tree, "active-ulabel", "region_cityscapes_or_tensor")
    rng = np.random.RandomState(2)
    for _, lbl, _ in base.im_idx:
        stem = os.path.basename(lbl).split(".")[0]
        write_gray8(str(tmp_path / f"{stem}.png"),
                    rng.randint(0, 20, (40, 56)).astype(np.uint8))
    tfs = ((ptf.get_train_transform("rescale_769_nospx", cfg, seed=3),
            jtf.get_train_transform("rescale_769_nospx", jcfg, seed=3))
           if with_transform else (None, None))
    port = pd.RegionDatasetPlbl(cfg, base.im_idx, str(tmp_path), tfs[0])
    jax = jd.RegionDatasetPlbl(jcfg, base.im_idx, str(tmp_path), tfs[1])
    for _ in range(2):
        for i in range(len(port)):
            _same_item(port[i], jax[i])


@pytest.mark.parametrize("dataset", ["cityscapes", "gta5"])
def test_val_dataset_matches_jax(tree, dataset):
    cfg, jcfg = _cfgs(tree, dataset=dataset,
                      num_classes=19 if dataset == "cityscapes" else 6)
    val_list = os.path.join(cfg.datalist_dir, "val.txt")
    port = pd.ValDataset(cfg, val_list, ptf.get_val_transform(cfg))
    jax = jd.ValDataset(jcfg, val_list, jtf.get_val_transform(jcfg))
    assert len(port) == 2
    for i in range(len(port)):
        got = port[i]
        _same_item(got, jax[i])
    assert got["images"].shape[1:] == ((1024, 2048) if dataset ==
                                       "cityscapes" else (40, 56))


def test_superpixel_files_read_as_the_jax_package_reads_them(tmp_path):
    rng = np.random.RandomState(3)
    spx = rng.randint(0, 3000, (17, 23)).astype(np.int32)
    paths = {}
    Image.fromarray(spx.astype(np.uint16)).save(
        str(tmp_path / "s16.png"))
    Image.fromarray((spx % 256).astype(np.uint8)).save(
        str(tmp_path / "s8.png"))
    with open(tmp_path / "s.pkl", "wb") as f:
        pickle.dump({"labels": spx}, f)
    np.save(tmp_path / "s.npy", spx)
    np.save(tmp_path / "d.npy", np.asarray({"labels": spx}, dtype=object))
    for name in ("s16.png", "s8.png", "s.pkl", "s.npy", "d.npy"):
        paths[name] = str(tmp_path / name)
        got = pd.open_spx(paths[name])
        want = jd.open_spx(paths[name])
        assert got.dtype == np.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(pd.open_spx(paths["s16.png"]), spx)
    g16 = read_gray(paths["s16.png"])
    assert g16.dtype == np.uint16
    np.testing.assert_array_equal(
        g16, np.asarray(Image.open(paths["s16.png"])))
    with pytest.raises(ValueError, match="8-bit greyscale"):
        read_gray8(paths["s16.png"])
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(
        str(tmp_path / "p.png"))
    with pytest.raises(ValueError, match="16-bit greyscale"):
        read_gray(str(tmp_path / "p.png"))
    with pytest.raises(ValueError, match="unsupported"):
        pd.open_spx(str(tmp_path / "s.jpg"))


def test_region_dict_both_formats(tmp_path):
    import json

    sizes = {"a.pkl": [6, [1, 4]], "b.pkl": [3, []]}
    ids = {"a.pkl": [0, 2], "b.pkl": [1]}
    for name, data in (("sizes.json", sizes), ("ids.json", ids)):
        (tmp_path / name).write_text(json.dumps(data))
        assert pd.load_region_dict(str(tmp_path / name)) == \
            jd.load_region_dict(str(tmp_path / name))
    assert pd.load_region_dict(str(tmp_path / "sizes.json"))["a.pkl"] == \
        [0, 2, 3, 5]


@pytest.mark.parametrize("trim", [True, False])
def test_label_assignment_matches_the_jax_tool(tree, tmp_path, trim):
    root, dl = tree
    with open(os.path.join(dl, f"train_seed{NSEG}.txt")) as f:
        rows = [l.split("\t") for l in f.read().splitlines()]
    samples = [(pd.encode_cityscapes(pd.open_label(os.path.join(root, l))),
                pd.open_spx(os.path.join(root, s))) for _, l, s in rows]
    for gt, spx in samples:
        for k in (3, 5):
            b = label_assignment.boundaries_thick(spx)
            np.testing.assert_array_equal(b, jax_la.boundaries_thick(spx))
            np.testing.assert_array_equal(
                label_assignment.dilate_square(b, k),
                jax_la.dilate_square(b, k))
    label_assignment.generate_multi_hot_dataset(
        samples, NSEG, 19, str(tmp_path / "port"), trim=trim, trim_kernel=5)
    jax_la.generate_multi_hot_dataset(
        samples, NSEG, 19, str(tmp_path / "jax"), trim=trim, trim_kernel=5)
    for name in ("multi_hot_cls.npy", "sp_size.npy", "sp_gt_size.npy"):
        a = np.load(tmp_path / "port" / name)
        b = np.load(tmp_path / "jax" / name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
    if trim:  # the tree's own tensors are these
        cfg, _ = _cfgs(tree)
        np.testing.assert_array_equal(
            np.load(pd.multi_hot_paths(cfg)["multi_hot_cls"]),
            np.load(tmp_path / "port" / "multi_hot_cls.npy"))


def test_datalist_tools_match_the_jax_tools(tree, tmp_path):
    root, dl = tree
    with open(os.path.join(dl, f"train_seed{NSEG}.txt")) as f:
        triples = [tuple(l.split("\t")) for l in f.read().splitlines()]
    for mod, out in ((gen_datalists, "port"), (jax_gen, "jax")):
        mod.gen_datalist(triples, str(tmp_path / out / "list.txt"))
        mod.gen_region_dict(triples, NSEG, str(tmp_path / out / "r.dict"),
                            data_root=root)
    for name in ("list.txt", "r.dict"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    with open(os.path.join(dl, "train.dict"), "rb") as f:
        assert (tmp_path / "port" / "r.dict").read_bytes() == f.read()


def test_dataset_pickles_without_its_multi_hot_copy(tree):
    port, _ = _or_pair(tree, "active-label", "region_cityscapes_or_tensor")
    assert isinstance(port.multi_hot_cls, np.memmap)
    assert port.__getstate__()["multi_hot_cls"] == (
        "mmap", port.multi_hot_cls.filename)
    back = pickle.loads(pickle.dumps(port))
    assert isinstance(back.multi_hot_cls, np.memmap)
    np.testing.assert_array_equal(back.multi_hot_cls, port.multi_hot_cls)
    _select(port, back, 4)
    a, b = back.load(0, port.draw(0)), port.load(0, back.draw(0))
    assert a.keys() == b.keys() and a["fnames"] == b["fnames"]
    for k in set(a) - {"fnames"}:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _batches(provider):
    out = list(provider)
    getattr(provider, "close", lambda: None)()  # the JAX one has none
    return out


def test_process_loader_gives_the_jax_batches(tree):
    port, jax = _or_pair(tree, "active-label", "region_cityscapes_or_tensor")
    _select(port, jax, 2)
    kw = dict(shuffle=True, drop_last=False, infinite=False, seed=7)
    got = _batches(DataProvider(port, 3, num_workers=2, **kw))
    want = _batches(JaxProvider(jax, 3, num_workers=1, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["fnames"] == w["fnames"]
        for k in set(g) - {"fnames"}:
            want_k = np.asarray(w[k])
            if k == "images":
                want_k = want_k.transpose(0, 3, 1, 2)
            np.testing.assert_array_equal(g[k], want_k, err_msg=k)


def test_process_workers_never_share_a_draw(tree, tmp_path):
    """Identical files behind every item: an item crop repeated in one
    epoch would mean two workers drew the same parameters."""
    root, dl = tree
    copy = tmp_path / "tree"
    shutil.copytree(root, copy)
    cfg, _ = _cfgs((str(copy), dl.replace(root, str(copy))))
    ds = pd.RegionDatasetOr(cfg, cfg.trg_datalist, cfg.region_dict,
                            "active-label",
                            ptf.get_train_transform("rescale_769_multi_notrg",
                                                    cfg, seed=0))
    first = [os.path.join(str(copy), p) for p in ds.im_idx[0]]
    for paths in ds.im_idx[1:]:
        for src, dst in zip(first, paths):
            shutil.copyfile(src, dst)
    batches = _batches(DataProvider(ds, 2, num_workers=2, shuffle=False,
                                    drop_last=False, infinite=False))
    images = [im for b in batches for im in b["images"]]
    assert len(images) == 4
    for i in range(4):
        for j in range(i):
            assert not np.array_equal(images[i], images[j]), (i, j)
    # the same items as one process drawing in item order
    ref = pd.RegionDatasetOr(cfg, cfg.trg_datalist, cfg.region_dict,
                             "active-label",
                             ptf.get_train_transform(
                                 "rescale_769_multi_notrg", cfg, seed=0))
    for i, im in enumerate(images):
        np.testing.assert_array_equal(im, ref[i]["images"])


def test_decode_cache_cap(tree, monkeypatch):
    root, _ = tree
    cache = pd._DecodeCache()
    calls = []

    def load():
        calls.append(1)
        return np.zeros(1024 * 1024, np.uint8)

    monkeypatch.setenv("MULACTSEG_DECODE_CACHE_MB", "0")
    cache.get("a", load), cache.get("a", load)
    assert len(calls) == 2
    monkeypatch.setenv("MULACTSEG_DECODE_CACHE_MB", "2")
    for key in ("a", "b", "a", "c", "a"):
        cache.get(key, load)
    # a 2 MB cap holds two of the 1 MB arrays; "b" was the least recent
    assert len(calls) == 5 and cache.peek("b") is None
    assert cache.peek("a") is not None and cache.peek("c") is not None


def _shared_blocks():
    return {f for f in os.listdir("/dev/shm") if f.startswith("psm_")}


def test_closing_a_process_loader_frees_its_shared_blocks(tree):
    """Items come back from the workers through shared memory; a provider
    closed with batches in flight frees their blocks."""
    port, _ = _or_pair(tree, "active-label", "region_cityscapes_or_tensor")
    start_workers(2)
    before = _shared_blocks()
    loader = DataProvider(port, 2, num_workers=2)
    batch = next(loader)
    assert batch["images"].shape == (2, 3) + CROP
    loader.close()
    assert _shared_blocks() == before
