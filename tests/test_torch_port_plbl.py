"""The port's pseudo-labelling path (mulactseg_tpu_torch.ops.segment_max,
plbl/, utils/png.py) against the JAX package, on the CPU.

- K5's plain version against segment_max_pallas in interpret mode (after
  the segment-sorted gather, mapped back through the order) and against
  the scan seg_max_argmax: max values and argmax pixels exactly, on exact
  ties, negative values, +-0.0, an all-0.0 segment, absent ids and
  all-invalid pixels (-0.0 and +0.0 compare equal).
- segment_max_grad's value and gradient against JAX's custom_vjp: 1e-6.
- selected_spx_adjacency's copy: exactly.
- cosine_prototype_plbl with sim_bf16=False: the maps exactly, in every
  flag combination tested, once with JAX's K5 in Pallas interpret mode.
  With sim_bf16=True both sides round the operands to bfloat16 and sum in
  float32 in another order, so near-tie decisions may flip: >= 99% of
  pixels agree.
- PseudoLabelGenerator.generate end to end on the small model twin
  (weights carried by models/convert.py): the model's float32 outputs
  agree to ~1e-5, which can flip a near-tie prototype choice, so the PNG
  maps agree on >= 99% of pixels and the IoU/precision/recall tables
  within 0.5 points.
- The PNG writer: a round trip through PIL, exactly.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

from mulactseg_tpu.config import Config as JaxConfig
from mulactseg_tpu.data.synthetic import SyntheticRegionDataset
from mulactseg_tpu.ops.segment import seg_context, seg_max_argmax
from mulactseg_tpu.ops.segment import segment_max_grad as jax_smg
from mulactseg_tpu.ops.segment_pallas import segment_max_pallas
from mulactseg_tpu.plbl import cosine_prototype_plbl as jax_cosine_plbl
from mulactseg_tpu.plbl import selected_spx_adjacency as jax_adjacency
from mulactseg_tpu.plbl import generator as jax_generator
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.data.synthetic import grid_superpixels
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.ops import _build
from mulactseg_tpu_torch.ops.segment_max import (
    seg_max_fwd,
    segment_max_grad,
    segment_max_plain,
)
from mulactseg_tpu_torch.plbl import (
    METHOD_TO_PLBL,
    PLBL_TYPES,
    PseudoLabelGenerator,
    cosine_prototype_plbl,
    plbl_save_dir,
    selected_spx_adjacency,
)
from mulactseg_tpu_torch.utils.png import read_gray8, write_gray8
from tests.test_torch_port_model import NC, jax_variables, twin_pair

torch.set_num_threads(1)


def _seg_case(kind, seed=0, P=1000, S=13, C=5):
    rng = np.random.RandomState(seed)
    sid = rng.randint(0, S + 1, size=P).astype(np.int32)
    sid[sid == 4] = S  # segment 4 is absent
    vals = rng.rand(P, C).astype(np.float32)
    if kind == "ties":
        vals = np.round(vals * 4) / 4  # many exact ties in each segment
    elif kind == "negative":
        vals = np.round(rng.randn(P, C).astype(np.float32) * 8) / 8 - 3.0
    elif kind == "signed_zero":
        vals = np.where(rng.rand(P, C) < 0.5, -0.0, 0.0).astype(np.float32)
        vals[rng.rand(P, C) < 0.3] = -1.0
    elif kind == "all_zero_segment":
        vals[sid == 2] = 0.0
        vals[sid == 3] = -0.0
    elif kind == "all_invalid":
        sid[:] = S
    return vals, sid, S


def _jax_pallas(vals, sid, S):
    """segment_max_pallas in interpret mode after the sorted gather, with
    the positions mapped back to pixels (ops/segment.py:280-297)."""
    P = vals.shape[0]
    ctx = seg_context(jnp.asarray(sid), S)
    g = jnp.take(jnp.asarray(vals), ctx.order, axis=0)
    v, pos = segment_max_pallas(g, ctx.starts, ctx.ends, fill=0.0,
                                interpret=True)
    order = np.append(np.asarray(ctx.order), P)
    return np.asarray(v), order[np.clip(np.asarray(pos), 0, P)]


@pytest.mark.parametrize("kind", ["random", "ties", "negative", "signed_zero",
                                  "all_zero_segment", "all_invalid"])
def test_segment_max_plain_matches_pallas_and_scan(kind):
    vals, sid, S = _seg_case(kind)
    P = vals.shape[0]
    got_v, got_i = segment_max_plain(torch.from_numpy(vals),
                                     torch.from_numpy(sid), S)
    got_v, got_i = got_v.numpy(), got_i.numpy()
    scan_v, scan_i = jax.jit(
        lambda s, v: seg_max_argmax(seg_context(s, S), v, fill=0.0))(
        jnp.asarray(sid), jnp.asarray(vals))
    for want_v, want_i in (_jax_pallas(vals, sid, S),
                           (np.asarray(scan_v), np.asarray(scan_i))):
        np.testing.assert_array_equal(got_v, want_v)
        np.testing.assert_array_equal(got_i, want_i)
    absent = got_i == P
    assert (got_v[absent] == 0.0).all()
    if kind != "all_invalid":
        assert absent[4].all() and not absent.all()
    if kind == "all_zero_segment":
        # a present segment of 0.0 values records its first pixel
        for s in (2, 3):
            assert (got_i[s] == np.nonzero(sid == s)[0][0]).all()
    # CPU tensors take the plain version and launch nothing
    _build.reset_launches()
    v2, i2 = seg_max_fwd(torch.from_numpy(vals), torch.from_numpy(sid), S)
    assert torch.equal(i2, torch.from_numpy(got_i))
    assert dict(_build.LAUNCHES) == {}


def test_segment_max_plain_takes_class_planes():
    """The (C, P) planes of an NCHW tensor, viewed as (P, C), give the same
    result as the contiguous array."""
    vals, sid, S = _seg_case("ties", seed=1)
    planes = torch.from_numpy(np.ascontiguousarray(vals.T)).t()
    assert planes.stride() == (1, vals.shape[0])
    a = segment_max_plain(planes, torch.from_numpy(sid), S)
    b = segment_max_plain(torch.from_numpy(vals), torch.from_numpy(sid), S)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_segment_max_grad_matches_custom_vjp():
    vals, sid, S = _seg_case("random", seed=2, P=512, S=11, C=3)
    vals = vals + 0.01
    w = np.random.RandomState(3).rand(S, 3).astype(np.float32)
    vt = torch.from_numpy(vals).requires_grad_(True)
    mx, pix = segment_max_grad(vt, torch.from_numpy(sid), S)
    (torch.from_numpy(w) * torch.log(mx + 1e-8)).sum().backward()
    assert not pix.requires_grad

    def f(v):
        m, p = jax_smg(v, jnp.asarray(sid), S)
        return jnp.sum(jnp.asarray(w) * jnp.log(m + 1e-8)), (m, p)

    (_, (want_mx, want_pix)), want_g = jax.jit(
        jax.value_and_grad(f, has_aux=True))(jnp.asarray(vals))
    np.testing.assert_allclose(mx.detach().numpy(), np.asarray(want_mx),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(pix.numpy(), np.asarray(want_pix))
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(vt.grad.numpy(), want_g, rtol=1e-6, atol=1e-6)


def _softmax(x, axis):
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def _plbl_case(seed=0):
    """tests/test_plbl.py's fixture: 12x12 image, 3x3 grid superpixels,
    4 classes, 8 feature channels, 4 selected superpixels."""
    rng = np.random.RandomState(seed)
    H = W = 12
    S, C, Ch = 9, 4, 8
    spx_map = grid_superpixels(H, W, S)
    feats = rng.randn(H * W, Ch).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    probs = _softmax(rng.randn(H * W, C).astype(np.float32), 1)
    targets = np.zeros((S, C), np.float32)
    for s in range(S):
        targets[s, rng.choice(C, rng.randint(1, 3), replace=False)] = 1
    selected = [0, 2, 4, 7]
    spmask = np.isin(spx_map, selected)
    return feats, probs, targets, spx_map, spmask, selected, S


@pytest.mark.parametrize("include_onehot", [True, False])
def test_selected_spx_adjacency_matches_jax(include_onehot):
    rng = np.random.RandomState(4)
    spx_map = rng.randint(0, 11, (17, 23)).astype(np.int32)
    spx_map[0, 0] = 12  # an id past nseg goes to the sink
    targets = (rng.rand(11, 6) < 0.4).astype(np.float32)
    args = (spx_map, [0, 3, 5, 6, 10], 11, targets)
    got = selected_spx_adjacency(*args, max_protos=9,
                                 include_onehot=include_onehot)
    want = jax_adjacency(*args, max_protos=9, include_onehot=include_onehot)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _both(case, include_onehot, chunk, **kw):
    """Port and JAX maps on one fixture; the port gets the features and
    probabilities as (P, C) views of (C, P) planes, as the generator
    passes them."""
    feats, probs, targets, spx_map, spmask, selected, S = case
    proto = selected_spx_adjacency(spx_map, selected, S, targets,
                                   max_protos=32,
                                   include_onehot=include_onehot)
    pixel_valid = spmask.reshape(-1).copy()
    if not include_onehot:
        pixel_valid &= (targets.sum(1) > 1)[spx_map.reshape(-1)]
    spx = spx_map.reshape(-1)
    got = cosine_prototype_plbl(
        torch.from_numpy(np.ascontiguousarray(feats.T)).t(),
        torch.from_numpy(np.ascontiguousarray(probs.T)).t(),
        torch.from_numpy(spx), torch.from_numpy(pixel_valid),
        *(torch.from_numpy(a) for a in proto), nseg=S, chunk=chunk, **kw)
    want = jax_cosine_plbl(
        jnp.asarray(feats), jnp.asarray(probs), jnp.asarray(spx),
        jnp.asarray(pixel_valid), *(jnp.asarray(a) for a in proto), nseg=S,
        chunk=chunk, **kw)
    assert got.dtype == torch.int32
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("include_onehot,kw", [
    (True, {}),
    (False, {}),
    (True, {"threshold_median": False}),
    (True, {"propagate": False}),
    (False, {"propagate": False}),
    (True, {"propagate": False, "filter_within_by_pred": True}),
    (False, {"filter_prop_by_pred": True}),
    (True, {"filter_within_by_pred": True, "filter_prop_by_pred": True}),
], ids=["onehot-median", "multi-median", "onehot-min", "withinspx-onehot",
        "withinspx", "filtgt", "filtered", "both-filters"])
def test_cosine_prototype_plbl_matches_jax(include_onehot, kw):
    got, want = _both(_plbl_case(), include_onehot, 64, **kw)
    np.testing.assert_array_equal(got, want)
    assert (got != 255).any()
    if kw.get("propagate", True):
        assert ((got != 255) & ~_plbl_case()[4].reshape(-1)).any()


def test_cosine_prototype_plbl_matches_jax_pallas_k5(monkeypatch):
    """JAX's K5 through segment_max_pallas in interpret mode (chunk 40 is
    used nowhere else, so the jitted function is traced anew under the
    environment variable)."""
    monkeypatch.setenv("MULACTSEG_FORCE_PALLAS_INTERPRET", "1")
    got, want = _both(_plbl_case(seed=5), True, 40)
    np.testing.assert_array_equal(got, want)


def test_cosine_prototype_plbl_sim_bf16_agrees_with_jax():
    case = _plbl_case(seed=3)
    got, want = _both(case, True, 64, sim_bf16=True)
    exact, _ = _both(case, True, 64)
    assert (got == want).mean() >= 0.99
    assert (got != 255).any() and (got == exact).mean() >= 0.9


def _twin_batches(n, H=32, W=32, num_classes=NC - 1, nseg=16):
    """Eval-all batches from the JAX package's synthetic fixture: labels
    with ignore mapped to the extra class, uint8 images (NHWC for JAX,
    NCHW for the port)."""
    ds = SyntheticRegionDataset(n_images=n, H=H, W=W,
                                num_classes=num_classes, nseg=nseg,
                                split="active-label", seed=3)
    rng = np.random.RandomState(6)
    jax_b, port_b = [], []
    for i in range(n):
        s = ds[i]
        img = rng.randint(0, 256, (1, H, W, 3)).astype(np.uint8)
        # a third of the superpixels selected, with 1-3 classes each
        spmask = np.isin(s["spx"], np.nonzero(rng.rand(nseg) < 0.6)[0])
        common = {
            "labels": np.where(s["labels"] == 255, num_classes,
                               s["labels"])[None],
            "target": s["target"][None], "spx": s["spx"][None],
            "spmask": spmask[None], "fnames": [s["fnames"]]}
        jax_b.append({"images": img, **common})
        port_b.append({"images": img.transpose(0, 3, 1, 2).copy(), **common})
    return jax_b, port_b, ds.suppix


def test_generator_matches_jax_end_to_end(tmp_path):
    port, ref = twin_pair(separable=False)
    v = jax_variables(ref, 7)
    convert.load_variables(port, v)
    jax_b, port_b, suppix = _twin_batches(3)
    kw = dict(num_classes=NC - 1, nseg=16, dtype="float32",
              method="active_joint_multi_predignore_lossdecomp")
    jgen = jax_generator.PseudoLabelGenerator(
        ref, JaxConfig(**kw), plbl_type="cosprop_includeonehot",
        max_protos=64)
    want = jgen.generate(v["params"], v["batch_stats"], jax_b,
                         save_dir=str(tmp_path / "jax"), suppix=suppix)
    gen = PseudoLabelGenerator(port, Config(**kw), "cosprop_includeonehot",
                               max_protos=64, device="cpu")
    _build.reset_launches()
    got = gen.generate(None, port_b, save_dir=str(tmp_path / "port"),
                       suppix=suppix)
    assert dict(_build.LAUNCHES) == {}  # CPU: plain versions only
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
    agree = []
    for name in names:
        a = np.asarray(Image.open(tmp_path / "jax" / name))
        b = np.asarray(Image.open(tmp_path / "port" / name))
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        agree.append((a == b).mean())
        # the map the generator computes is the map it saved
        m = gen.plbl_for_batch(port_b[names.index(name)], suppix).numpy()
        np.testing.assert_array_equal(m, b)
    assert min(agree) >= 0.99, agree
    assert abs(got[0] - want[0]) <= 0.5
    for g_t, w_t in zip(got[1:], want[1:]):
        g_v = np.array(g_t.split(","), float)
        w_v = np.array(w_t.split(","), float)
        assert g_v.shape == w_v.shape == (NC + 1,)
        np.testing.assert_allclose(g_v, w_v, atol=0.5)


def test_generator_types_and_names_match_jax(tmp_path):
    assert PLBL_TYPES == jax_generator.PLBL_TYPES
    assert METHOD_TO_PLBL == jax_generator.METHOD_TO_PLBL
    assert plbl_save_dir("/x/checkpoint00.tar", "cosprop", "00") == \
        jax_generator.plbl_save_dir("/x/checkpoint00.tar", "cosprop", "00")
    assert plbl_save_dir("/x/c.tar", None, "01") == \
        jax_generator.plbl_save_dir("/x/c.tar", None, "01")
    cfg = Config(num_classes=5, nseg=16)
    model = torch.nn.Conv2d(3, 6, 1)
    # every type builds (test_torch_port_simple_plbl.py and
    # test_torch_port_sliding.py hold the ten ported last against JAX)
    for ptype in ("naive", "cos_naiveprop", "cosprop_plusonehot",
                  "cosprop_onehot", "cosprop_includeonehot_slide",
                  "within_multihot", "candidate_prop"):
        gen = PseudoLabelGenerator(model, cfg, ptype, device="cpu")
        assert (gen.sliding is not None) == ptype.endswith("_slide")
    tta = PseudoLabelGenerator(model, Config(num_classes=5, nseg=16,
                                             dtype="bfloat16"),
                               use_tta=True, device="cpu")
    assert tta.use_tta and tta.sim_bf16 and not tta.feat_bf16
    with pytest.raises(KeyError):
        PseudoLabelGenerator(model, cfg, "no_such_type", device="cpu")
    gen = PseudoLabelGenerator(model, Config(num_classes=5, nseg=16,
                                             save_vis=True), device="cpu")
    save_dir = os.path.join(tmp_path, "round_01")
    gen.generate(None, [], save_dir=save_dir)
    assert os.path.isdir(save_dir) and os.path.isdir(save_dir + "_vis")


def test_png_writer_round_trip(tmp_path):
    rng = np.random.RandomState(8)
    for shape in ((37, 53), (1, 1), (64, 128)):
        m = rng.randint(0, 256, shape).astype(np.uint8)
        m[:, : shape[1] // 2] = 255
        path = str(tmp_path / f"m{shape[0]}.png")
        write_gray8(path, m)
        with Image.open(path) as im:
            assert im.mode == "L" and im.size == (shape[1], shape[0])
            np.testing.assert_array_equal(np.asarray(im), m)
        np.testing.assert_array_equal(read_gray8(path), m)
    with pytest.raises(ValueError):
        write_gray8(path, m.astype(np.int32))
    data = bytearray(open(path, "rb").read())
    data[40] ^= 0xFF  # inside the IDAT data: the CRC no longer matches
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_gray8(path)
