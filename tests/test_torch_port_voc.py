"""The port's PASCAL VOC path against the JAX package, on the CPU, over a
small VOC-format tree (tools/voc_tree.py: baseline JPEG images, palette
label PNGs, .pkl superpixels at nseg 24, the multi-hot tensors with 22
channels, two image sizes, both odd) and a 21-class small model twin (the
twin of test_torch_port_model.py with VOC's class count, dropout off).

- Loader items: RegionDatasetOr on both splits (identity encoding, the
  pascal_voc_seg multi-hot path, the last channel dropped),
  EvalRegionDatasetAll, RegionDatasetPlbl and ValDataset with the
  identity transform equal the JAX package's items key by key, bitwise,
  over two passes (the JAX package decodes the JPEGs with Pillow); the
  label tool with identity encoding gives the JAX tool's tensors.
- The VOC criteria at step 0 of make_train_step on loader batches:
  active_joint_multi_lossdecomp (on the 21-class model) and active, the
  loss within rtol 1e-5, float32; lossdecomp's parts within 1e-4 (the
  group term, a segment max of a softmax at T = 0.1, multiplies by ten
  the ~1e-6 differences of two float32 train-mode forwards: measured
  1.9e-5).
- models/layers.resize_bilinear at non-integer ratios, down and up (the
  TTA sizes 281x375 <-> 562x750 among them), within 1e-5 of the JAX
  package's; the twin's features and logits with return_feat at 281x375
  and 562x750 within 1e-4.
- engine/tta.tta_feat_forward with the default 5 scales x 2 flips:
  features and logits within 1e-4 abs of the JAX package's, float32.
- The generator with use_tta on the tree's labelled images (the VOC
  eval_save_cosplbl_prop_includeonehot_voc_ms step, TTA_SCALES shrunk to
  two scales in both packages as tests/test_voc_tta_pipeline.py does):
  pseudo-label maps exactly the JAX generator's.
- The JAX package's own faults on the VOC recipe, confirmed and recorded
  in ROADMAP.md rather than repaired: the eval command's transform name
  eval_spx_identity_ms is unknown to it (a KeyError), and its collate
  cannot stack mixed-size VOC images (the reason for --val_batch_size 1).
  The port does what the JAX package does in both.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulactseg_tpu.cli.common import build_active_datasets as jax_build
from mulactseg_tpu.config import Config as JaxConfig
from mulactseg_tpu.data import datasets as jd
from mulactseg_tpu.data import transforms as jtf
from mulactseg_tpu.data.loader import collate as jax_collate
from mulactseg_tpu.engine import tta as jax_tta
from mulactseg_tpu.engine.state import create_train_state
from mulactseg_tpu.engine.train import make_train_step as jax_make_train_step
from mulactseg_tpu.models.deeplab import DeepLabHeadV3Plus as JaxHead
from mulactseg_tpu.models.deeplab import DeepLabV3 as JaxDeepLab
from mulactseg_tpu.models.layers import resize_bilinear as jax_resize
from mulactseg_tpu.models.resnet import ResNet as JaxResNet
from mulactseg_tpu.plbl import generator as jax_generator
from mulactseg_tpu_torch.cli.common import build_active_datasets
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.data import datasets as pd
from mulactseg_tpu_torch.data import transforms as ptf
from mulactseg_tpu_torch.data.loader import collate
from mulactseg_tpu_torch.engine import tta
from mulactseg_tpu_torch.engine.train import make_train_step
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.models.deeplab import DeepLabHeadV3Plus, DeepLabV3
from mulactseg_tpu_torch.models.layers import Dropout, resize_bilinear
from mulactseg_tpu_torch.models.resnet import ResNet
from mulactseg_tpu_torch.ops import _build
from mulactseg_tpu_torch.plbl.generator import PseudoLabelGenerator
from mulactseg_tpu_torch.tools.voc_tree import write_tree
from mulactseg_tpu_torch.utils.png import read_gray8, write_gray8
from tests.test_torch_port_loaders import _same_item
from tests.test_torch_port_model import jax_variables

torch.set_num_threads(1)

C, NSEG, CROP = 21, 24, (24, 24)
SIZES = ((23, 31), (30, 22))  # (H, W) of the tree's images, in turn


def voc_twins():
    """(port, JAX) small twins with VOC's 21 outputs (the architecture of
    test_torch_port_model.twin_pair, separable head)."""
    port = DeepLabV3(
        ResNet(layers=(2, 2, 2, 2), deep_stem=True, stem_width=16,
               stage_planes=(16, 32, 64, 128)),
        DeepLabHeadV3Plus(512, 64, C, (6, 12, 18), variant="wn",
                          separable=True, low_channels=12, mid_channels=64))
    ref = JaxDeepLab(
        backbone=JaxResNet(layers=(2, 2, 2, 2), deep_stem=True,
                           stem_width=16,
                           replace_stride_with_dilation=(False, False, True),
                           stage_planes=(16, 32, 64, 128)),
        classifier=JaxHead(C, (6, 12, 18), variant="wn", separable=True,
                           low_channels=12, mid_channels=64))
    return port, ref


def port_twin(variables):
    port, _ = voc_twins()
    convert.load_variables(port, variables)
    for m in port.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return port


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    dl = write_tree(str(root), 4, 2, NSEG, seed=2, sizes=SIZES)
    return str(root), dl


def _cfgs(tree, **kw):
    root, dl = tree
    base = dict(dataset="voc", num_classes=C, data_root=root,
                datalist_dir=dl, nseg=NSEG, crop_size=CROP, dtype="float32",
                loader="region_voc_or_tensor",
                train_transform="rescale_513_multi_notrg")
    base.update(kw)
    return Config(**base).derive_paths(), JaxConfig(**base).derive_paths()


def _or_pair(cfg, jcfg, split, seed=5):
    tfs = ((ptf.get_train_transform(cfg.train_transform, cfg, seed=seed),
            jtf.get_train_transform(jcfg.train_transform, jcfg, seed=seed))
           if split == "active-label" else (None, None))
    port = pd.RegionDatasetOr(cfg, cfg.trg_datalist, cfg.region_dict, split,
                              transform=tfs[0], encode_fn=pd.encode_identity)
    ref = jd.RegionDatasetOr(jcfg, jcfg.trg_datalist, jcfg.region_dict,
                             split, transform=tfs[1],
                             encode_fn=jd.encode_identity)
    rng = np.random.RandomState(seed)
    for key in list(port.suppix):  # the same half of each image selected
        sel = sorted(rng.choice(port.suppix[key], NSEG // 2,
                                replace=False).tolist())
        port.suppix[key], ref.suppix[key] = sel, list(sel)
    return port, ref


def _plbl_dir(tree, port_ds):
    """The tree's label maps saved as pseudo-label PNGs, <label id>.png."""
    out = os.path.join(tree[0], "plbl")
    os.makedirs(out, exist_ok=True)
    for _, lbl, _ in port_ds.im_idx:
        write_gray8(os.path.join(out, os.path.basename(lbl)),
                    pd.open_label(lbl))
    return out


def _datasets(tree, kind, cfg, jcfg):
    if kind == "val":
        val = os.path.join(cfg.datalist_dir, "val.txt")
        return (pd.ValDataset(cfg, val, ptf.get_val_transform(cfg),
                              encode_fn=pd.encode_identity),
                jd.ValDataset(jcfg, val, jtf.get_val_transform(jcfg),
                              encode_fn=jd.encode_identity))
    split = "active-ulabel" if kind == "pool" else "active-label"
    port, ref = _or_pair(cfg, jcfg, split)
    if kind == "eval_all":
        return (pd.EvalRegionDatasetAll(cfg, port, port.suppix, emit_u8=True),
                jd.EvalRegionDatasetAll(jcfg, ref, ref.suppix, emit_u8=True))
    if kind == "plbl":
        d = _plbl_dir(tree, port)
        return (pd.RegionDatasetPlbl(cfg, port.im_idx, d,
                                     ptf.get_train_transform(
                                         "rescale_513_notrg", cfg, seed=3)),
                jd.RegionDatasetPlbl(jcfg, ref.im_idx, d,
                                     jtf.get_train_transform(
                                         "rescale_513_notrg", jcfg, seed=3)))
    return port, ref


@pytest.mark.parametrize("kind", ["label", "pool", "eval_all", "plbl",
                                  "val"])
def test_voc_loader_items_match_jax(tree, kind):
    cfg, jcfg = _cfgs(tree)
    port, ref = _datasets(tree, kind, cfg, jcfg)
    assert len(port) == len(ref) > 0
    shapes = set()
    for _ in range(2):
        for i in range(len(ref)):
            got, want = port[i], ref[i]
            _same_item(got, want)
            shapes.add(got["images"].shape[1:])
            if "target" in got:
                assert got["target"].shape == (NSEG, C)  # 22 - the last
    if kind in ("pool", "eval_all", "val"):  # full-size images
        assert shapes == set(SIZES)
    pd._decode_cache.clear()
    jd._decode_cache.clear()


def test_voc_multi_hot_tool_matches_jax(tree, tmp_path):
    """The port's label tool with identity encoding over the tree's
    palette labels equals the JAX tool over Pillow's reading of them, and
    equals the tree's own tensors."""
    from mulactseg_tpu.tools import label_assignment as jax_la
    from mulactseg_tpu_torch.tools import label_assignment

    root, dl = tree
    datalist = os.path.join(dl, f"train_seed{NSEG}.txt")
    label_assignment.main(["--datalist", datalist, "--data_root", root,
                           "--save_data_dir", str(tmp_path / "port"),
                           "--nseg", str(NSEG), "--num_classes", str(C),
                           "--trim_multihot_boundary", "--trim_kernel_size",
                           "5", "--label-encoding", "identity"])
    with open(datalist) as f:
        rows = [l.split("\t") for l in f.read().splitlines()]
    jax_la.generate_multi_hot_dataset(
        [(jd.encode_identity(jd.open_label(os.path.join(root, l))),
          jd.open_spx(os.path.join(root, s))) for _, l, s in rows],
        NSEG, C, str(tmp_path / "jax"), trim=True, trim_kernel=5)
    cfg, _ = _cfgs(tree)
    tree_mh = np.load(pd.multi_hot_paths(cfg)["multi_hot_cls"])
    assert tree_mh.shape == (4, NSEG, C + 1) and tree_mh[..., -1].any()
    for name in ("multi_hot_cls.npy", "sp_size.npy", "sp_gt_size.npy"):
        got = np.load(tmp_path / "port" / name)
        np.testing.assert_array_equal(got, np.load(tmp_path / "jax" / name),
                                      err_msg=name)
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / "multi_hot_cls.npy"), tree_mh)
    pd._decode_cache.clear()
    jd._decode_cache.clear()


def _batch(tree, method, cfg, jcfg, B=4):
    """A collated training batch of the tree from each package's loader:
    lossdecomp from RegionDatasetOr, CE from RegionDatasetPlbl."""
    port, ref = _datasets(tree, "label" if "lossdecomp" in method else
                          "plbl", cfg, jcfg)
    idx = [i % len(port) for i in range(B)]
    got = collate([port[i] for i in idx])
    want = jax_collate([ref[i] for i in idx])
    np.testing.assert_array_equal(got["images"],
                                  want["images"].transpose(0, 3, 1, 2))
    return got, {k: jnp.asarray(v) for k, v in want.items()
                 if k != "fnames"}


@pytest.mark.parametrize("method", ["active_joint_multi_lossdecomp",
                                    "active"])
def test_voc_criteria_step0_match_jax(tree, monkeypatch, method):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, **kw: x)
    H = 33
    cfg, jcfg = _cfgs(tree, method=method, crop_size=(H, H), train_lr=1e-4,
                      finetune_itrs=3)
    assert cfg.num_model_classes == jcfg.num_model_classes == C
    batch, jbatch = _batch(tree, method, cfg, jcfg)
    port, ref = voc_twins()
    v = jax_variables(ref, 4)
    step = make_train_step(port_twin(v), cfg, device="cpu")
    aux = step(batch)
    state = create_train_state(ref, jcfg, jax.random.PRNGKey(0),
                               (4, H, H, 3))
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"],
                          opt_state=state.tx.init(v["params"]))
    _, jaux = jax_make_train_step(ref, jcfg, donate=False)(
        state, jbatch, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(aux["train_loss"]),
                               float(jaux["train_loss"]), rtol=1e-5)
    for k in ("ce_loss", "mc_loss", "group_loss") if "lossdecomp" in \
            method else ():
        assert float(aux[k]) > 0, k
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-4,
                                   err_msg=k)
    pd._decode_cache.clear()


@pytest.mark.parametrize("src,dst", [((281, 375), (562, 750)),
                                     ((562, 750), (281, 375)),
                                     ((375, 500), (281, 375)),
                                     ((23, 31), (28, 38)), ((17, 23), (7, 5))])
def test_resize_bilinear_matches_jax_at_non_integer_ratios(src, dst):
    x = np.random.RandomState(sum(src)).randn(1, 4, *src).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(x), dst).numpy()
    want = np.asarray(jax_resize(jnp.asarray(x.transpose(0, 2, 3, 1)), dst))
    assert got.shape == (1, 4, *dst)
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), rtol=0,
                               atol=1e-5)


def _images(H, W, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(1, H, W, 3) * np.asarray([1.0, 0.7, 1.3])).astype(
        np.float32)


@pytest.mark.parametrize("size", [(281, 375), (562, 750)])
def test_twin_features_at_tta_sizes_match_jax(size):
    port, ref = voc_twins()
    v = jax_variables(ref, 5)
    x = _images(*size, 6)
    feat, logits = port_twin(v).eval()(torch.from_numpy(
        x.transpose(0, 3, 1, 2).copy()), return_feat=True)
    jfeat, jlogits = jax.jit(lambda p, b, a: ref.apply(
        {"params": p, "batch_stats": b}, a, train=False, return_feat=True))(
        v["params"], v["batch_stats"], jnp.asarray(x))
    for g, w in ((feat, jfeat), (logits, jlogits)):
        assert g.shape[-2:] == size
        np.testing.assert_allclose(g.detach().numpy(),
                                   np.asarray(w).transpose(0, 3, 1, 2),
                                   rtol=0, atol=1e-4)


def test_tta_feat_forward_matches_jax():
    assert tta.TTA_SCALES == jax_tta.TTA_SCALES == (0.5, 0.75, 1.0, 1.25,
                                                    1.5)
    port, ref = voc_twins()
    v = jax_variables(ref, 6)
    x = _images(45, 61, 7)
    feat, logits = tta.tta_feat_forward(
        port_twin(v), torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
        torch.device("cpu"), autocast=False)
    jfeat, jlogits = jax_tta.tta_feat_forward(ref, v["params"],
                                              v["batch_stats"],
                                              jnp.asarray(x))
    assert feat.shape == (1, 64, 45, 61) and logits.shape == (1, C, 45, 61)
    np.testing.assert_allclose(feat.norm(dim=1).numpy(), 1.0, atol=1e-5)
    for g, w in ((feat, jfeat), (logits, jlogits)):
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(w).transpose(0, 3, 1, 2),
                                   rtol=0, atol=1e-4)


def test_tta_plbl_maps_exactly_jax(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_tta, "TTA_SCALES", (0.75, 1.0))
    monkeypatch.setattr(tta, "TTA_SCALES", (0.75, 1.0))
    method = "eval_save_cosplbl_prop_includeonehot_voc_ms"
    cfg, jcfg = _cfgs(tree, method=method)
    assert cfg.num_model_classes == C
    port_ds, ref_ds = _datasets(tree, "eval_all", cfg, jcfg)
    port_b = [collate([port_ds[i]]) for i in range(len(port_ds))]
    ref_b = [jax_collate([ref_ds[i]]) for i in range(len(ref_ds))]
    port, ref = voc_twins()
    v = jax_variables(ref, 8)
    want = jax_generator.PseudoLabelGenerator(
        ref, jcfg, "cosprop_includeonehot", use_tta=True).generate(
        v["params"], v["batch_stats"], ref_b,
        save_dir=str(tmp_path / "jax"), suppix=ref_ds.suppix)
    gen = PseudoLabelGenerator(port_twin(v), cfg, "cosprop_includeonehot",
                               use_tta=True, device="cpu")
    _build.reset_launches()
    got = gen.generate(None, port_b, save_dir=str(tmp_path / "port"),
                       suppix=port_ds.suppix)
    assert dict(_build.LAUNCHES) == {}  # CPU: plain versions only
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 4 and sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        np.testing.assert_array_equal(read_gray8(str(tmp_path / "port" / name)),
                                      read_gray8(str(tmp_path / "jax" / name)),
                                      name)
    assert got == want
    pd._decode_cache.clear()


def test_jax_eval_transform_name_is_a_key_error(tree):
    """(a): the JAX script's eval command names eval_spx_identity_ms, which
    data/transforms.get_train_transform does not know; build_active_datasets
    raises. The port's script passes eval_spx_identity."""
    cfg, jcfg = _cfgs(tree, train_transform="eval_spx_identity_ms",
                      loader="eval_region_voc_all_ms", stage2=True)
    with pytest.raises(KeyError, match="eval_spx_identity_ms"):
        jax_build(jcfg)
    with pytest.raises(KeyError, match="eval_spx_identity_ms"):
        build_active_datasets(cfg)
    ok, _ = _cfgs(tree, train_transform="eval_spx_identity",
                  loader="eval_region_voc_all_ms", stage2=True)
    active, val = build_active_datasets(ok)
    assert len(active.trg_pool_dataset) == 4 and len(val) == 2


def test_jax_collate_fails_on_mixed_sizes(tree):
    """(b): VOC images differ in size and the JAX package's collate stacks
    a batch's images, so validation and pool scoring at the default
    val_batch_size 4 fail; the port's collate fails alike (it neither pads
    nor loops), and its script passes --val_batch_size 1."""
    cfg, jcfg = _cfgs(tree)
    for kind in ("val", "pool"):
        port, ref = _datasets(tree, kind, cfg, jcfg)
        assert port[0]["images"].shape[1:] != port[1]["images"].shape[1:]
        with pytest.raises(ValueError):
            jax_collate([ref[0], ref[1]])
        with pytest.raises(ValueError):
            collate([port[0], port[1]])
    pd._decode_cache.clear()
