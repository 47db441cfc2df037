"""The port's selection path (data/transforms.normalize, data/synthetic.py,
data/loader.py, active/active_set.py, acquisition/) against the JAX
package, on the CPU.

- normalize, SyntheticRegionDataset items (every split) and the
  DataProvider's
  batch order (shuffle, drop_last, single epoch or infinite, a dataset
  smaller than the batch): bitwise the JAX package's. The port's images
  are channel-first; the tests transpose them before comparing.
- Each scoring function on logits with absent regions, exact ties in the
  top-1 class and the undefined channel dominant in some regions: values
  within rtol 1e-5 / atol 1e-6 (float32 segment sums in another order:
  JAX differences prefix sums, the port adds with index_add_), votes,
  top-1 ids and the absent regions' 0.0 exactly. A present region whose
  pixels are all confident (BvSB ~1e-8 at T 0.1) can come out exactly 0.0
  in JAX, where its prefix-sum difference cancels; the port gives its
  mean.
- All 8 selectors, with fair_counting on and off, from stub trainers that
  serve the same logits to both packages: scores within 1e-6; the
  selected (image, spx) sets, the order and regions of the selection JSON
  and the datalist JSON identical (the selection JSON holds the float
  scores themselves, so its scores are held within 1e-6; my_random's
  file, whose scores are the same draws, is byte for byte the same). The
  fixture has no near-tie at the budget's edge: each test asserts that
  the gap there exceeds the measured score deviation.
"""

import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mulactseg_tpu.acquisition import scoring as jax_scoring
from mulactseg_tpu.acquisition.selectors import SELECTORS as JAX_SELECTORS
from mulactseg_tpu.acquisition.selectors import get_selector as jax_get
from mulactseg_tpu.active import RegionActiveSet as JaxActiveSet
from mulactseg_tpu.config import Config as JaxConfig
from mulactseg_tpu.data import loader as jax_loader
from mulactseg_tpu.data import synthetic as jax_synthetic
from mulactseg_tpu.data.transforms import normalize as jax_normalize
from mulactseg_tpu_torch.acquisition import SELECTORS, get_selector, scoring
from mulactseg_tpu_torch.active import RegionActiveSet
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.data import loader, synthetic
from mulactseg_tpu_torch.data.transforms import normalize

torch.set_num_threads(1)

C = 5  # dataset classes; the predignore model has C + 1 outputs


def _hwc(a):
    return np.ascontiguousarray(np.asarray(a).transpose(1, 2, 0))


def test_normalize_matches_jax_bitwise():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (37, 29, 3)).astype(np.uint8)
    img[0, :3] = [[0, 0, 0], [255, 255, 255], [128, 7, 250]]
    got = normalize(img)
    assert got.dtype == np.float32 and got.shape == (3, 37, 29)
    np.testing.assert_array_equal(_hwc(got).view(np.int32),
                                  jax_normalize(img).view(np.int32))
    # a strided view takes the same values
    np.testing.assert_array_equal(_hwc(normalize(img[:, ::2])),
                                  jax_normalize(img[:, ::2]))
    with pytest.raises(ValueError, match="uint8"):
        normalize(img.astype(np.float32))


@pytest.mark.parametrize("split", ["active-label", "active-ulabel", "val"])
def test_synthetic_dataset_matches_jax(split):
    kw = dict(n_images=3, H=24, W=20, num_classes=C, nseg=16, split=split,
              seed=4)
    a, b = synthetic.SyntheticRegionDataset(**kw), \
        jax_synthetic.SyntheticRegionDataset(**kw)
    assert a.im_idx == b.im_idx and a.suppix == b.suppix
    assert a.id_to_index == b.id_to_index and len(a) == len(b) == 3
    np.testing.assert_array_equal(a.multi_hot_cls, b.multi_hot_cls)
    np.testing.assert_array_equal(a.isselected, b.isselected)
    for x in (a, b):  # a selection as the active set makes them
        x.suppix["spx_1.pkl"] = [0, 5, 7]
    for i in range(len(a)):
        got, want = a[i], b[i]
        assert sorted(got) == sorted(want), (sorted(got), sorted(want))
        for k, v in want.items():
            g = got[k]
            if k == "images":
                assert g.shape == (3, 24, 20)
                g = _hwc(g)
            if isinstance(v, np.ndarray):
                assert g.dtype == v.dtype, k
                np.testing.assert_array_equal(g, v, err_msg=k)
            else:
                assert g == v, k
    if split == "active-label":
        assert a[1]["spmask"].any() and not a[1]["spmask"].all()
    np.testing.assert_array_equal(
        synthetic.multi_hot_from_gt(b.gts[0], b.spx_map, 16, C),
        jax_synthetic.multi_hot_from_gt(b.gts[0], b.spx_map, 16, C))
    np.testing.assert_array_equal(
        synthetic._blobby_labels(np.random.RandomState(1), 13, 9, C),
        jax_synthetic._blobby_labels(np.random.RandomState(1), 13, 9, C))


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"images": np.full((2, 2), i, np.float32), "fnames": [f"{i}"]}


@pytest.mark.parametrize("n,bs,shuffle,drop_last,infinite", [
    (10, 3, True, True, True),
    (10, 3, False, False, False),
    (10, 3, True, False, False),
    (10, 4, True, True, False),
    (2, 4, True, True, True),  # smaller than the batch: with replacement
])
def test_data_provider_order_matches_jax(n, bs, shuffle, drop_last,
                                         infinite):
    kw = dict(batch_size=bs, shuffle=shuffle, drop_last=drop_last,
              infinite=infinite, num_workers=3, seed=5)
    a = loader.DataProvider(_Items(n), **kw)
    b = jax_loader.DataProvider(_Items(n), **kw)
    assert len(a) == len(b)
    if infinite:
        got = [next(a) for _ in range(9)]
        want = [next(b) for _ in range(9)]
    else:
        got, want = list(a), list(b)
        assert [x["fnames"] for x in list(a)] == \
            [x["fnames"] for x in list(b)]  # a second epoch
    a.close()
    assert [x["fnames"] for x in got] == [x["fnames"] for x in want]
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x["images"], y["images"])
    sample = [_Items(3)[i] | {"spx": np.zeros(2, np.int32), "extra": i}
              for i in range(3)]
    c, d = loader.collate(sample), jax_loader.collate(sample)
    assert c.keys() == d.keys() and c["extra"] == d["extra"] == [0, 1, 2]
    np.testing.assert_array_equal(c["spx"], d["spx"])


# -- scoring -----------------------------------------------------------------

def _score_inputs(seed=0, B=3, H=12, W=10, nseg=9, nc=C + 1):
    """NCHW logits and (B, H, W) ids: segment 8 absent everywhere and
    segment 3 absent in image 1; ids == nseg (invalid) on a few pixels;
    exact ties between the two largest logits on ~10% of pixels; the last
    (undefined) channel dominant in segment 2 of every image."""
    rng = np.random.RandomState(seed)
    spx = rng.randint(0, nseg - 1, (B, H, W)).astype(np.int32)
    spx[1][spx[1] == 3] = 4
    spx[:, 0, :2] = nseg
    logits = (rng.randn(B, nc, H, W) * 2).astype(np.float32)
    tie = rng.rand(B, H, W) < 0.1
    top = logits.max(axis=1)
    logits[:, 1] = np.where(tie, top, logits[:, 1])
    logits[:, 3] = np.where(tie, top, logits[:, 3])
    logits[:, -1] += np.where(spx == 2, 8.0, 0.0).astype(np.float32)
    return logits, spx


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_scoring_matches_jax():
    nseg, temp = 9, 0.1
    logits, spx = _score_inputs()
    lt, st = torch.from_numpy(logits), torch.from_numpy(spx)
    lj, sj = jnp.asarray(logits.transpose(0, 2, 3, 1)), jnp.asarray(spx)

    bv, t1 = scoring.bvsb_top1(lt, temp)
    jbv, jt1 = jax_scoring.bvsb_top1(lj, temp)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(jt1))
    _close(bv, jbv)
    tied = np.asarray(jbv) == np.float32(1.0 + 1e-8)
    assert tied.any() and (bv.numpy()[tied] == np.float32(1.0 + 1e-8)).all()

    for drop_last in (False, True):
        got = scoring.region_bvsb_scores(lt, st, nseg=nseg, temp=temp,
                                         drop_last=drop_last).numpy()
        want = np.asarray(jax_scoring.region_bvsb_scores(
            lj, sj, nseg=nseg, temp=temp, drop_last=drop_last))
        _close(got, want)
        for s in (got, want):  # absent regions: exactly 0.0
            assert (s[:, 8] == 0).all() and s[1, 3] == 0
        assert (got[:, :8] != 0).sum() == 3 * 8 - 1

    m = scoring.mean_softmax(lt, temp)
    jm = jax_scoring.mean_softmax(lj, temp)
    _close(m, jm)
    w = scoring.cls_weight_pwr(m, 8.0)
    _close(w, jax_scoring.cls_weight_pwr(jm, 8.0))

    r, v = scoring.region_weighted_bvsb_and_votes(lt, st, w, nseg=nseg,
                                                  temp=temp)
    jr, jv = jax_scoring.region_weighted_bvsb_and_votes(
        lj, sj, jnp.asarray(w.numpy()), nseg=nseg, temp=temp)
    assert v.dtype == torch.int32
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    _close(r, jr)
    for s in (r.numpy(), np.asarray(jr)):
        assert (s[:, 8] == 0).all() and s[1, 3] == 0
    assert (r.numpy()[:, :8] != 0).sum() == 3 * 8 - 1

    rows = r.numpy()
    n = scoring.minmax_normalize(torch.from_numpy(rows)).numpy()
    jn = np.asarray(jax_scoring.minmax_normalize(jnp.asarray(rows)))
    _close(n, jn)
    assert n.min() < 0 and np.isclose(n.max(), 1.0)
    for votes in (v.numpy(), np.array(jv)):
        ban = scoring.ban_ignore_dominant(torch.from_numpy(n),
                                          torch.from_numpy(votes)).numpy()
        jban = np.asarray(jax_scoring.ban_ignore_dominant(
            jnp.asarray(n), jnp.asarray(votes)))
        np.testing.assert_array_equal(ban, jban)
        assert (ban[:, 2] == 0).all()
    # ties in the vote counts go to the first class, as jnp.argmax
    tie = np.zeros((1, 2, C + 1), np.int32)
    tie[0, 0, [1, C]] = 4
    tie[0, 1, [C, 2]] = [5, 5]
    s = np.ones((1, 2), np.float32)
    np.testing.assert_array_equal(
        scoring.ban_ignore_dominant(torch.from_numpy(s),
                                    torch.from_numpy(tie)).numpy(),
        np.asarray(jax_scoring.ban_ignore_dominant(jnp.asarray(s),
                                                   jnp.asarray(tie))))


# -- selectors ---------------------------------------------------------------

N_POOL, HW, NSEG = 6, 24, 16


def _stub_logits(pool):
    """Per-image NHWC logits keyed by the normalised image's bytes:
    smooth random fields (so region means spread out) with the undefined
    channel dominant in two superpixels of every image."""
    rng = np.random.RandomState(11)
    table = {}
    for i in range(len(pool)):
        coarse = rng.randn(4, 4, C + 1).astype(np.float32) * 3
        ys = np.arange(HW) * 4 // HW
        lg = coarse[np.ix_(ys, ys)] + rng.randn(HW, HW, C + 1).astype(
            np.float32) * 0.5
        spx = pool.spx_map
        lg[..., -1] += np.where(np.isin(spx, [i, 15 - i]), 10.0, 0.0)
        table[jax_normalize(pool.images[i]).tobytes()] = lg.astype(
            np.float32)
    return table


class _JaxStub:
    def __init__(self, table):
        self.table = table

    def predict_logits(self, images):
        return jnp.asarray(np.stack([self.table[np.ascontiguousarray(
            im).tobytes()] for im in np.asarray(images)]))


class _PortStub(_JaxStub):
    def predict_logits(self, images):
        return torch.from_numpy(np.stack([self.table[_hwc(im).tobytes()]
                                          for im in images]).transpose(
            0, 3, 1, 2).copy())


def _sets(make, cfg):
    kw = dict(n_images=N_POOL, H=HW, W=HW, num_classes=C, nseg=NSEG, seed=2)
    pool = make(split="active-ulabel", **kw)
    label = make(split="active-label", **kw)
    label.suppix, label.im_idx = {}, []
    return pool, label


def _spy(selector):
    seen = {}
    orig = selector.calculate_scores

    def wrapped(trainer, pool_set):
        seen["scores"] = orig(trainer, pool_set)
        return seen["scores"]

    selector.calculate_scores = wrapped
    return seen


def _read(d, name):
    with open(os.path.join(d, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("fair", [True, False])
@pytest.mark.parametrize("name", sorted(JAX_SELECTORS))
def test_selectors_match_jax(tmp_path, name, fair):
    assert sorted(SELECTORS) == sorted(JAX_SELECTORS)
    budget = 40 if fair else 20
    common = dict(num_classes=C, nseg=NSEG, val_batch_size=4,
                  val_num_workers=2, fair_counting=fair, seed=3,
                  method="active_joint_multi_predignore_lossdecomp",
                  active_method=name)
    out = {}
    for side, cfg_cls, sets_cls, make, get, stub in (
            ("jax", JaxConfig, JaxActiveSet,
             jax_synthetic.SyntheticRegionDataset, jax_get, _JaxStub),
            ("port", Config, RegionActiveSet,
             synthetic.SyntheticRegionDataset, get_selector, _PortStub)):
        cfg = cfg_cls(model_save_dir=str(tmp_path / side), **common)
        pool, label = _sets(make, cfg)
        active = sets_cls(cfg, pool, label)
        active.selection_iter = 2
        sel = get(name, cfg)
        seen = _spy(sel)
        counts = sel.select_next_batch(stub(_stub_logits(pool)), active,
                                       budget)
        active.dump_datalist()
        out[side] = (counts, seen.get("scores"), active, pool)
    (jc, js, ja, jpool), (pc, ps, pa, ppool) = out["jax"], out["port"]
    assert pc == jc
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files
    assert _read(tmp_path / "port", "datalist_02.json") == \
        _read(tmp_path / "jax", "datalist_02.json")
    np.testing.assert_array_equal(ppool.isselected, jpool.isselected)
    if name == "dummy":
        assert pc == (0, 0) and files == ["datalist_02.json"]
        return
    assert [s[1:] for s in ps] == [s[1:] for s in js]
    dev = max(abs(a[0] - b[0]) for a, b in zip(ps, js))
    assert dev <= 1e-6, dev
    sel_file = f"{sel.active_method}_selection_02.json"
    assert files == ["datalist_02.json", sel_file]
    got = json.loads(_read(tmp_path / "port", sel_file))
    want = json.loads(_read(tmp_path / "jax", sel_file))
    assert [g[1:] for g in got] == [w[1:] for w in want]
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=0, atol=1e-6)
    if name == "my_random":
        assert _read(tmp_path / "port", sel_file) == \
            _read(tmp_path / "jax", sel_file)
    # no near-tie at the budget's edge: the last chosen region and the
    # first left out lie further apart than the two packages' scores
    ranked = sorted(js, reverse=True)
    edge = ranked[len(want) - 1][0] - ranked[len(want)][0]
    assert edge > dev, (edge, dev)
    chosen = {(p, i) for _, p, i in want}
    assert sum(len(v) for v in pa.trg_label_dataset.suppix.values()) == \
        len(chosen) == pc[0]
    assert pa.trg_label_dataset.suppix == ja.trg_label_dataset.suppix


def test_active_set_expand_and_datalist_round_trip(tmp_path):
    """expand_training_set on one hand-made ranking, with the budget
    passed in the middle of a multi-class region, then load_datalist
    into fresh datasets."""
    out = {}
    for side, cfg_cls, sets_cls, make in (
            ("jax", JaxConfig, JaxActiveSet,
             jax_synthetic.SyntheticRegionDataset),
            ("port", Config, RegionActiveSet,
             synthetic.SyntheticRegionDataset)):
        cfg = cfg_cls(model_save_dir=str(tmp_path / side), num_classes=C,
                      nseg=NSEG)
        pool, label = _sets(make, cfg)
        active = sets_cls(cfg, pool, label)
        active.selection_iter = 1
        ranking = [(1.0 - 0.01 * k, ",".join(pool.im_idx[k % 3]), k)
                   for k in range(12)]
        out[side] = active.expand_training_set(ranking, 7, "x")
        active.dump_datalist()
    assert out["port"] == out["jax"] and out["port"][1] > 7
    for f in ("datalist_01.json", "x_selection_01.json"):
        assert _read(tmp_path / "port", f) == _read(tmp_path / "jax", f)
    cfg = Config(model_save_dir=str(tmp_path / "port"), num_classes=C,
                 nseg=NSEG)
    pool2, label2 = _sets(synthetic.SyntheticRegionDataset, cfg)
    again = RegionActiveSet(cfg, pool2, label2)
    again.selection_iter = 1
    again.load_datalist()
    assert again.get_trainset() is label2
    assert label2.im_idx == active.trg_label_dataset.im_idx
    assert label2.suppix == active.trg_label_dataset.suppix
    assert pool2.im_idx == active.trg_pool_dataset.im_idx
    assert pool2.suppix == active.trg_pool_dataset.suppix
