"""The port's simple pseudo-labels (mulactseg_tpu_torch/plbl/simple.py), the
generator's ten types ported last, its targets from a dominant map and its
overlays, against the JAX package, on the CPU.

- within_multihot_plbl, naive_argmax_plbl, naive_threshold_plbl (plbl_th 0
  and > 0) and naive_threshold_fill on the same logits: exactly, ties and
  all-negative candidate logits included. The JAX package jits
  naive_threshold_plbl with plbl_th traced, so its `if plbl_th > 0` cannot
  run (ROADMAP.md, question 8): the port is held against the function it
  wraps, and the JAX generator's `naive` type runs with that function.
- _dominant_to_targets (cosprop_onehot drops the extra channel,
  cosprop_onehotignore keeps it) and cosprop_plusonehot's overwrite of the
  one-hot superpixels: exactly.
- decode_labels and the overlay PNG against the JAX generator's _decode
  and its PIL file: exactly, Cityscapes and VOC colours.
- PseudoLabelGenerator.generate end to end on the small model twin for the
  ten types (the slide type in test_torch_port_sliding.py): the model's
  float32 outputs agree to ~1e-5, which can flip a near-tie, so the maps
  agree on >= 99% of pixels and the IoU/precision/recall tables within 0.5
  points, as test_torch_port_plbl.py holds the recipe's type. The onehot
  types get batches whose 'target' is the per-pixel dominant map, which
  no JAX loader gives the generator (ROADMAP.md, question 7). K5 runs on
  the cosine types' path only: on the CPU, its plain version, counted.
"""

import contextlib
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from PIL import Image

from mulactseg_tpu.config import Config as JaxConfig
from mulactseg_tpu.plbl import generator as jax_generator
from mulactseg_tpu.plbl import simple as jax_simple
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.ops import segment_max
from mulactseg_tpu_torch.plbl import simple
from mulactseg_tpu_torch.plbl.generator import (
    PseudoLabelGenerator,
    decode_labels,
    save_overlay,
)
from mulactseg_tpu_torch.tools.label_assignment import (
    dominant_label_for_image,
)
from mulactseg_tpu_torch.utils.png import read_gray8, read_rgb8
from tests.test_torch_port_model import NC, jax_variables, twin_pair
from tests.test_torch_port_plbl import _twin_batches

torch.set_num_threads(1)

B, C, H, W, S = 2, 7, 9, 13, 6


def _case(seed=0, ties=False):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, H, W, C).astype(np.float32)
    if ties:
        logits = np.round(logits * 2) / 2
    logits[0, 0, 0] = -np.abs(logits[0, 0, 0])  # all candidates negative
    targets = (rng.rand(B, S, C) < 0.4).astype(np.float32)
    spx = rng.randint(0, S, (B, H, W)).astype(np.int32)
    spmask = rng.rand(B, H, W) < 0.6
    plbl = np.where(spmask, rng.randint(0, C, (B, H, W)), 255).astype(
        np.int32)
    return logits, targets, spx, spmask, plbl


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("ties", [False, True])
def test_simple_plbl_functions_match_jax(ties):
    logits, targets, spx, spmask, plbl = _case(3, ties)
    lt, tt = _nchw(logits), torch.from_numpy(targets)
    st, mt = torch.from_numpy(spx), torch.from_numpy(spmask)
    got = simple.within_multihot_plbl(lt, tt, st, mt)
    want = jax_simple.within_multihot_plbl(
        jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(spx),
        jnp.asarray(spmask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for n in (C, C - 1, 3):
        np.testing.assert_array_equal(
            simple.naive_argmax_plbl(lt, mt, num_real_classes=n).numpy(),
            np.asarray(jax_simple.naive_argmax_plbl(
                jnp.asarray(logits), jnp.asarray(spmask),
                num_real_classes=n)))
    naive = jax_simple.naive_threshold_plbl.__wrapped__
    for th in (0.0, 0.3, 0.6):
        np.testing.assert_array_equal(
            simple.naive_threshold_plbl(lt, mt, plbl_th=th).numpy(),
            np.asarray(naive(jnp.asarray(logits), jnp.asarray(spmask),
                             plbl_th=th)))
    for b in range(B):
        for temp, th in ((0.1, 0.0), (0.1, 0.9), (1.0, 0.4)):
            got = simple.naive_threshold_fill(
                torch.from_numpy(plbl[b]), lt[b], mt[b], temp=temp,
                plbl_th=th)
            want = jax_simple.naive_threshold_fill(
                jnp.asarray(plbl[b]), jnp.asarray(logits[b]),
                jnp.asarray(spmask[b]), temp=temp, plbl_th=th)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_jax_naive_threshold_plbl_cannot_trace_its_threshold():
    """The JAX package's jitted function fails on its own Python branch,
    at any threshold (ROADMAP.md, question 8)."""
    logits, _, _, spmask, _ = _case(1)
    with pytest.raises(Exception, match="[Tt]racer"):
        jax_simple.naive_threshold_plbl(jnp.asarray(logits),
                                        jnp.asarray(spmask), plbl_th=0.0)


def _dominant_batch(seed, nseg=16, num_classes=NC - 1):
    """A dominant map (255 outside the selected superpixels, some 255
    inside) and its superpixel map."""
    rng = np.random.RandomState(seed)
    spx = rng.randint(0, nseg, (20, 24)).astype(np.int32)
    gt = rng.randint(0, num_classes, (20, 24))
    gt[rng.rand(20, 24) < 0.2] = 255
    dom = dominant_label_for_image(gt, spx, nseg, num_classes)
    sel = rng.rand(nseg) < 0.5
    return np.where(sel[spx], dom, 255), spx


@pytest.mark.parametrize("ptype", ["cosprop_onehot", "cosprop_onehotignore"])
def test_dominant_to_targets_matches_jax(ptype):
    kw = dict(num_classes=NC - 1, nseg=16)
    model = torch.nn.Conv2d(3, NC, 1)
    gen = PseudoLabelGenerator(model, Config(**kw), ptype, device="cpu")
    jgen = jax_generator.PseudoLabelGenerator(None, JaxConfig(**kw), ptype)
    for seed in range(3):
        dom, spx = _dominant_batch(seed)
        got = gen._dominant_to_targets(dom.astype(np.int64), spx)
        want = jgen._dominant_to_targets(dom.astype(np.int64), spx)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2] and got[2]
        assert got[0].shape[1] == NC - (ptype == "cosprop_onehot")


@pytest.mark.parametrize("dataset", ["cityscapes", "voc"])
def test_overlay_png_matches_jax_pil_file(dataset, tmp_path):
    nc = 19 if dataset == "cityscapes" else 21
    kw = dict(num_classes=nc, nseg=12, dataset=dataset, save_vis=True)
    rng = np.random.RandomState(4)
    spx = rng.randint(0, 12, (17, 21)).astype(np.int32)
    labels = rng.randint(0, nc, (17, 21)).astype(np.uint8)
    labels[rng.rand(17, 21) < 0.3] = 255
    jgen = jax_generator.PseudoLabelGenerator(
        None, JaxConfig(**kw), "within_multihot")
    np.testing.assert_array_equal(decode_labels(Config(**kw), labels),
                                  jgen._decode(labels))
    jgen._save_vis(labels, spx, str(tmp_path / "jax.png"))
    save_overlay(Config(**kw), labels, spx, str(tmp_path / "port.png"),
                 "cpu")
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    got = read_rgb8(str(tmp_path / "port.png"))
    assert got.shape == want.shape == (17, 21, 3)
    np.testing.assert_array_equal(got, want)
    assert (got == (255, 255, 0)).all(-1).any()


def _dominant_batches(port_b, jax_b, nseg=16):
    """The batches with 'target' replaced by the per-pixel dominant map of
    the GT over the selected superpixels (the extra class C as 255)."""
    out_p, out_j = [], []
    for pb, jb in zip(port_b, jax_b):
        spx = pb["spx"][0]
        gt = np.where(pb["labels"][0] == NC - 1, 255, pb["labels"][0])
        dom = dominant_label_for_image(gt, spx, nseg, NC - 1)
        dom = np.where(pb["spmask"][0], dom, 255)[None].astype(np.int32)
        out_p.append({**pb, "target": dom})
        out_j.append({**jb, "target": dom})
    return out_p, out_j


@contextlib.contextmanager
def count_k5():
    """Counts K5's calls (its plain version, on the CPU) in the block: a
    list with one entry a call."""
    calls = []
    real = segment_max.segment_max_plain

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(segment_max, "segment_max_plain", counted)
        yield calls


def compare_generate(ptype, tmp_path, port_b, jax_b, suppix, port, ref, v,
                     **cfg_kw):
    """Both generators' generate on the same batches: the PNG maps agree
    on >= 99% of pixels, each port PNG is the map plbl_for_batch gives,
    and the tables agree within 0.5 points. Returns the port's K5 calls."""
    kw = dict(num_classes=NC - 1, nseg=16, dtype="float32",
              method="active_joint_multi_predignore_lossdecomp", **cfg_kw)
    jgen = jax_generator.PseudoLabelGenerator(ref, JaxConfig(**kw),
                                              plbl_type=ptype, max_protos=64)
    want = jgen.generate(v["params"], v["batch_stats"], jax_b,
                         save_dir=str(tmp_path / "jax"), suppix=suppix)
    gen = PseudoLabelGenerator(port, Config(**kw), ptype, max_protos=64,
                               device="cpu")
    with count_k5() as calls:
        got = gen.generate(None, port_b, save_dir=str(tmp_path / "port"),
                           suppix=suppix)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and names
    for name in names:
        a = np.asarray(Image.open(tmp_path / "jax" / name))
        b = read_gray8(str(tmp_path / "port" / name))
        assert (a == b).mean() >= 0.99, (name, (a == b).mean())
        m = gen.plbl_for_batch(port_b[names.index(name)], suppix).numpy()
        np.testing.assert_array_equal(m, b)
    assert abs(got[0] - want[0]) <= 0.5
    for g_t, w_t in zip(got[1:], want[1:]):
        g_v = np.array(g_t.split(","), float)
        w_v = np.array(w_t.split(","), float)
        assert g_v.shape == w_v.shape == (NC + 1,)
        np.testing.assert_allclose(g_v, w_v, atol=0.5)
    if kw.get("save_vis"):
        vis = sorted(os.listdir(tmp_path / "port_vis"))
        assert vis == sorted(os.listdir(tmp_path / "jax_vis")) == names
        for name in vis:
            a = np.asarray(Image.open(tmp_path / "jax_vis" / name))
            b = read_rgb8(str(tmp_path / "port_vis" / name))
            assert a.shape == b.shape and (a == b).all(-1).mean() >= 0.99
    return len(calls)


# type -> the Config fields it reads (a threshold that fills part of the
# unselected pixels), and one run with the overlays
NEW_TYPES = {
    "cosprop_plusonehot": {"save_vis": True},
    "cos_naiveprop": {"ce_temp": 1.0, "plbl_th": 0.3},
    "cosprop_onehot": {},
    "cosprop_onehotignore": {},
    "naive_argmax": {},
    "naive": {"plbl_th": 0.3},
    "within_multihot": {},
    "candidate": {},
    "candidate_prop": {"ce_temp": 1.0, "plbl_th": 0.3},
}


@pytest.fixture(scope="module")
def twin():
    port, ref = twin_pair(separable=False)
    v = jax_variables(ref, 7)
    convert.load_variables(port, v)
    return port, ref, v


@pytest.mark.parametrize("ptype", sorted(NEW_TYPES))
def test_generator_type_matches_jax_end_to_end(ptype, twin, tmp_path,
                                               monkeypatch):
    port, ref, v = twin
    jax_b, port_b, suppix = _twin_batches(3)
    if ptype.startswith("cosprop_onehot"):
        port_b, jax_b = _dominant_batches(port_b, jax_b)
    # the JAX generator's `naive` runs the function its jit wraps
    monkeypatch.setattr(jax_generator, "naive_threshold_plbl",
                        jax_simple.naive_threshold_plbl.__wrapped__)
    k5 = compare_generate(ptype, tmp_path, port_b, jax_b, suppix, port, ref,
                          v, **NEW_TYPES[ptype])
    cosine = ptype.startswith("cos")
    assert k5 == (3 if cosine else 0)


def test_plusonehot_overwrite_is_jax_rule(twin):
    """cosprop_plusonehot is cosprop's map with each selected one-hot
    superpixel's pixels set to its class (JAX generator.py:661-672)."""
    port, _, _ = twin
    _, port_b, suppix = _twin_batches(2)
    kw = dict(num_classes=NC - 1, nseg=16, dtype="float32")
    plus = PseudoLabelGenerator(port, Config(**kw), "cosprop_plusonehot",
                                max_protos=64, device="cpu")
    base = PseudoLabelGenerator(port, Config(**kw), "cosprop",
                                max_protos=64, device="cpu")
    for b in port_b:
        # every third superpixel one-hot: its first candidate kept
        tgt = b["target"][0].copy()
        first = tgt.argmax(1)
        tgt[::3] = 0
        tgt[np.arange(0, len(tgt), 3), first[::3]] = 1
        b = {**b, "target": tgt[None]}
        got = plus.plbl_for_batch(b, suppix).numpy()
        want = base.plbl_for_batch(b, suppix).numpy()
        tgt, spx = b["target"][0], b["spx"][0]
        oh = b["spmask"][0] & (tgt.sum(1) == 1)[spx]
        want = np.where(oh, tgt.argmax(1)[spx], want)
        assert oh.any()
        np.testing.assert_array_equal(got, want)
