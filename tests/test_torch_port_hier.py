"""The port's two-scale hierarchy losses (mulactseg_tpu_torch/losses/
hier.py), their registry entries and the three hierarchy criteria against
the JAX package's, on the same numpy-seeded inputs.

B = 2 images of 32x24, nseg 16 big and 64 small irregular superpixels, 7
target channels (6 classes + the undefined one, which the losses slice
off), 60% of the big superpixels selected; the async variants' weak view
is 40x32 with maps of its own. Logits are N(0, 0.2^2), which leave the
softmax unsaturated (test_torch_port_criteria.py's module docstring): the
loss within 1e-5 relative, the logits gradient within 1e-5 of its largest
entry. The JAX side runs jitted on the CPU, its segment max the sorted
branch as its own tests run it.

- hier, only_single, aug (the border-stripped labels) and async with
  weight_reduce None, 'max' and 'mean'; border_spx_ids_mask with padded
  ids; the two LOSS_TYPES entries.
- K5 runs once an image for hier and async, twice with 'max' (counted on
  the plain version the CPU takes).
- On a padded crop the MC term gathers NaN target rows in both packages:
  equal finite losses, the gradient NaN on exactly the padded pixels
  (ROADMAP.md, open question 4).
- Step 0 of the three criteria through make_train_step against the JAX
  train step (tiny model pair of test_torch_port_criteria_step.py): the
  loss parts within 1e-5 relative, and the parameters after the AdamW
  step within 1e-4 relative in L2 over all leaves; async_weight once more
  on a batch of SyntheticRegionDataset's items with small_nseg and
  async_views.
- Those two options of SyntheticRegionDataset against the JAX fixture's:
  the same keys, bitwise.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mulactseg_tpu.engine import train as jax_train
from mulactseg_tpu.losses import hier as jax_hier
from mulactseg_tpu.losses import registry as jax_registry
from mulactseg_tpu_torch.data.synthetic import (
    SyntheticRegionDataset,
    irregular_superpixels,
)
from mulactseg_tpu_torch.engine.train import make_train_step
from mulactseg_tpu_torch.losses import hier
from mulactseg_tpu_torch.losses import registry
from mulactseg_tpu_torch.ops import segment_max
from tests.test_torch_port_criteria import CT, NSEG, configs, region_batch
from tests.test_torch_port_criteria_step import (
    _images,
    _jax_state,
    _params_tree,
    tiny_pair,
)
from tests.test_torch_port_train import _global_rel

torch.set_num_threads(1)

B, H, W, SMALL, HW_WEAK = 2, 32, 24, 64, (40, 32)
KW = dict(nseg=NSEG, small_nseg=SMALL, temp=0.1)


def hier_batch(rng):
    """region_batch with the small map and the weak view's maps: spx_small
    (B, H, W), images_weak (B, 3, 40, 32), spx_weak, spx_small_weak and
    spmask_weak (the same superpixels selected)."""
    batch = region_batch(rng)
    batch["spx_small"] = np.stack([irregular_superpixels(H, W, SMALL, rng)
                                   for _ in range(B)]).astype(np.int32)
    hw, ww = HW_WEAK
    batch["spx_weak"] = np.stack([irregular_superpixels(hw, ww, NSEG, rng)
                                  for _ in range(B)]).astype(np.int32)
    batch["spx_small_weak"] = np.stack([
        irregular_superpixels(hw, ww, SMALL, rng)
        for _ in range(B)]).astype(np.int32)
    sel = np.zeros((B, NSEG + 1), bool)
    for b in range(B):
        sel[b, np.unique(batch["spx"][b][batch["spmask"][b]])] = True
    batch["spmask_weak"] = np.take_along_axis(
        sel, batch["spx_weak"].reshape(B, -1), 1).reshape(B, hw, ww)
    batch["images_weak"] = rng.randn(B, 3, hw, ww).astype(np.float32)
    return batch


def fixture_batch(rng):
    """A training batch of SyntheticRegionDataset's items with the finer
    grid (SMALL) and the weak view's keys (the item's own, as both
    packages' fixtures make them), 10 of each image's 16 superpixels
    selected."""
    ds = SyntheticRegionDataset(n_images=B, H=H, W=W, num_classes=CT - 1,
                                nseg=NSEG, seed=int(rng.randint(1 << 16)),
                                small_nseg=SMALL, async_views=True)
    for key in ds.im_idx:
        ds.suppix[key[2]] = sorted(rng.choice(NSEG, 10, replace=False))
    items = [ds[i] for i in range(B)]
    return {k: np.stack([it[k] for it in items]) for k in items[0]
            if k not in ("fnames", "target_bits")}


def nhwc(x):
    return jnp.asarray(np.asarray(x).transpose(0, 2, 3, 1))


def check(port_fn, jax_fn, logits):
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss = port_fn(lt)
    loss.backward()
    jl, jg = jax.jit(jax.value_and_grad(jax_fn))(nhwc(logits))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert float(jl) > 0.0
    want = np.asarray(jg).transpose(0, 3, 1, 2)
    np.testing.assert_array_less(np.abs(lt.grad.numpy() - want),
                                 1e-5 * np.abs(want).max())


@pytest.mark.parametrize("variant", ["hier", "only_single", "aug"])
def test_hier_losses_match_jax(variant):
    rng = np.random.RandomState(len(variant))
    batch = hier_batch(rng)
    logits = (rng.randn(B, CT - 1, H, W) * 0.2).astype(np.float32)
    keys = ("target", "spx", "spx_small", "spmask")
    pfn, jfn = ((hier.aug_hier_group_multi_label_ce,
                 jax_hier.aug_hier_group_multi_label_ce) if variant == "aug"
                else (hier.hier_group_multi_label_ce,
                      jax_hier.hier_group_multi_label_ce))
    kw = dict(KW, only_single=variant == "only_single")
    check(lambda lg: pfn(lg, *(torch.from_numpy(batch[k]) for k in keys),
                         **kw),
          lambda lg: jfn(lg, *(jnp.asarray(batch[k]) for k in keys), **kw),
          logits)


@pytest.mark.parametrize("weight_reduce", [None, "max", "mean"])
def test_async_hier_loss_matches_jax(weight_reduce):
    rng = np.random.RandomState(7)
    batch = hier_batch(rng)
    logits = (rng.randn(B, CT - 1, H, W) * 0.2).astype(np.float32)
    weak = (rng.randn(B, CT - 1, *HW_WEAK) * 0.2).astype(np.float32)
    keys = ("target", "spx_weak", "spx_small", "spx_small_weak", "spmask",
            "spmask_weak")
    kw = dict(KW, weight_reduce=weight_reduce)
    check(lambda lg: hier.async_hier_group_multi_label_ce(
              lg, torch.from_numpy(weak),
              *(torch.from_numpy(batch[k]) for k in keys), **kw),
          lambda lg: jax_hier.async_hier_group_multi_label_ce(
              lg, nhwc(weak), *(jnp.asarray(batch[k]) for k in keys), **kw),
          logits)


def test_async_normaliser_drops_absent_small_superpixels():
    """A pair whose small superpixel is absent from the strong view (an
    empty sum, exactly 0) adds to the loss but not to the normaliser, in
    both packages: the strong view holds only half the small ids."""
    rng = np.random.RandomState(2)
    batch = hier_batch(rng)
    batch["spx_small"] = batch["spx_small"] % (SMALL // 2)
    logits = (rng.randn(B, CT - 1, H, W) * 0.2).astype(np.float32)
    weak = (rng.randn(B, CT - 1, *HW_WEAK) * 0.2).astype(np.float32)
    keys = ("target", "spx_weak", "spx_small", "spx_small_weak", "spmask",
            "spmask_weak")
    check(lambda lg: hier.async_hier_group_multi_label_ce(
              lg, torch.from_numpy(weak),
              *(torch.from_numpy(batch[k]) for k in keys), **KW),
          lambda lg: jax_hier.async_hier_group_multi_label_ce(
              lg, nhwc(weak), *(jnp.asarray(batch[k]) for k in keys), **KW),
          logits)


def test_border_mask_matches_jax():
    rng = np.random.RandomState(3)
    spx = irregular_superpixels(H, W, NSEG, rng)
    spx[H - 3:] = NSEG  # crop padding
    got = hier.border_spx_ids_mask(torch.from_numpy(spx), NSEG).numpy()
    want = np.asarray(jax_hier.border_spx_ids_mask(jnp.asarray(spx), NSEG))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < NSEG


@pytest.mark.parametrize("name", ["hierarchy_group_multi_label_ce",
                                  "joint_hierarchy_multi_loss"])
def test_hierarchy_loss_types_match_jax(name):
    rng = np.random.RandomState(4)
    batch = hier_batch(rng)
    logits = (rng.randn(B, CT - 1, H, W) * 0.2).astype(np.float32)
    cfg, jcfg = configs("active_joint_multi", dict(
        loss_type=name, small_nseg=SMALL, group_only_single=True))
    fn, jfn = registry.get_loss_type(cfg), jax_registry.get_loss_type(jcfg)
    keys = ("target", "spx", "spx_small", "spmask")
    tb = {k: torch.from_numpy(batch[k]) for k in keys}
    jb = {k: jnp.asarray(batch[k]) for k in keys}

    def total(out):
        return out[0] + out[1] if isinstance(out, tuple) else out

    check(lambda lg: total(fn(lg, tb)), lambda lg: total(jfn(lg, jb)),
          logits)


@pytest.mark.parametrize("weight_reduce,want", [(None, 1), ("max", 2),
                                                ("mean", 1)])
def test_k5_runs_once_an_image_and_twice_with_max(monkeypatch,
                                                  weight_reduce, want):
    calls = []
    plain = segment_max.segment_max_plain
    monkeypatch.setattr(segment_max, "segment_max_plain",
                        lambda *a: calls.append(a[2]) or plain(*a))
    rng = np.random.RandomState(5)
    batch = {k: torch.from_numpy(v) for k, v in hier_batch(rng).items()}
    logits = torch.from_numpy(rng.randn(B, CT - 1, H, W).astype(np.float32))
    weak = torch.from_numpy(rng.randn(B, CT - 1, *HW_WEAK).astype(
        np.float32))
    hier.async_hier_group_multi_label_ce(
        logits, weak, batch["target"], batch["spx_weak"], batch["spx_small"],
        batch["spx_small_weak"], batch["spmask"], batch["spmask_weak"],
        weight_reduce=weight_reduce, **KW)
    assert calls == ([NSEG, SMALL] if want == 2 else [NSEG]) * B
    calls.clear()
    hier.hier_group_multi_label_ce(logits, batch["target"], batch["spx"],
                                   batch["spx_small"], batch["spmask"], **KW)
    assert calls == [NSEG] * B


def _jbatch(batch):
    return {k: nhwc(x) if k.startswith("images") else jnp.asarray(x)
            for k, x in batch.items()}


STEP_CASES = [
    ("hier", "active_joint_hier_multi", {}),
    ("hier_nocropsp", "active_joint_hier_multi", {"nocropsp": True}),
    ("async", "active_joint_hier_multi_async", {}),
    ("async_weight", "active_joint_hier_multi_async_weight", {}),
    ("async_weight_mean", "active_joint_hier_multi_async_weight",
     {"weight_reduce": "mean"}),
    ("async_weight_fixture", "active_joint_hier_multi_async_weight", {}),
]


@pytest.mark.parametrize("case,method,over", STEP_CASES,
                         ids=[c[0] for c in STEP_CASES])
def test_step0_matches_jax_train_step(case, method, over):
    """The async criteria's weak forward runs on the step's incoming BN
    statistics in both (JAX's pre-step batch_stats; the port's eval
    forward before the train forward)."""
    rng = np.random.RandomState(200 + len(case))
    batch = fixture_batch(rng) if case.endswith("fixture") else hier_batch(
        rng)
    batch["images"] = _images(rng)
    if case.endswith("fixture"):
        # the weak view a copy of the strong, as the fixture makes it; the
        # fixture's own images (uniform uint8 noise) saturate the tiny
        # model's T = 0.1 softmax, where float32 ties move the weak argmax
        # (the N(0, 0.2^2) convention of test_torch_port_criteria.py)
        batch["images_weak"] = batch["images"]
    cfg, jcfg = configs(method, dict(over, small_nseg=SMALL, train_lr=1e-2))
    port, ref, v = tiny_pair(CT - 1, len(case))
    step = make_train_step(port, cfg, device="cpu")
    aux = step(batch)
    jstep = jax_train.make_train_step(ref, jcfg, donate=False)
    state, jaux = jstep(_jax_state(ref, jcfg, v), _jbatch(batch),
                        jax.random.PRNGKey(0))
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(jaux["group_loss"]) > 0.0
    err = _global_rel(_params_tree(port), state.params)
    assert err < 1e-4, err
    assert _global_rel(v["params"], state.params) > 20 * err


@pytest.mark.parametrize("method", ["active_joint_hier_multi",
                                    "active_joint_hier_multi_async_weight"])
def test_padded_crop_gives_nan_gradients_as_jax(method):
    """On a padded crop (the last 4 rows and 3 columns with id nseg,
    spmask False) the MC term gathers a NaN target row in both packages:
    the losses agree and are finite, and the logits gradient is NaN on
    exactly the padded pixels in both (ROADMAP.md, open question 4)."""
    from mulactseg_tpu_torch.engine.train import CRITERIA

    rng = np.random.RandomState(9)
    batch = hier_batch(rng)
    for k, v in (("spx", NSEG), ("spmask", False)):
        batch[k][:, H - 4:] = v
        batch[k][:, :, W - 3:] = v
    logits = (rng.randn(B, CT - 1, H, W) * 0.2).astype(np.float32)
    weak = (rng.randn(B, CT - 1, *HW_WEAK) * 0.2).astype(np.float32)
    cfg, jcfg = configs(method, dict(small_nseg=SMALL))
    lt = torch.from_numpy(logits).requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, aux = CRITERIA[method](cfg)(lt, dict(
        tb, logits_weak=torch.from_numpy(weak)))
    total.backward()
    jcrit = jax_train.CRITERIA[method](jcfg)
    jb = dict({k: jnp.asarray(v) for k, v in batch.items()},
              logits_weak=nhwc(weak))
    (jt, jaux), jg = jax.jit(jax.value_and_grad(
        lambda lg: jcrit(lg, jb), has_aux=True))(nhwc(logits))
    for k in jaux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                   rtol=1e-5, err_msg=k)
    assert np.isfinite(float(jt)) and float(jt) > 0
    pad = np.zeros((H, W), bool)
    pad[H - 4:], pad[:, W - 3:] = True, True
    for g in (lt.grad.numpy(), np.asarray(jg).transpose(0, 3, 1, 2)):
        np.testing.assert_array_equal(~np.isfinite(g).all(axis=1),
                                      np.broadcast_to(pad, (B, H, W)))


@pytest.mark.parametrize("small,async_views",
                         [(SMALL, False), (None, True), (SMALL, True)])
def test_synthetic_fixture_options_match_jax(small, async_views):
    """SyntheticRegionDataset's small_nseg and async_views against the JAX
    fixture's on one seed and selection: the same keys, each bitwise
    (images channel-first in the port)."""
    from mulactseg_tpu.data import synthetic as jax_synthetic

    kw = dict(n_images=3, H=H, W=W, num_classes=CT - 1, nseg=NSEG, seed=5,
              small_nseg=small, async_views=async_views)
    a = SyntheticRegionDataset(**kw)
    b = jax_synthetic.SyntheticRegionDataset(**kw)
    for x in (a, b):  # a selection as the active set makes them
        x.suppix["spx_1.pkl"] = [0, 5, 7]
    for i in range(3):
        got, want = a[i], b[i]
        assert sorted(got) == sorted(want), (sorted(got), sorted(want))
        assert ("spx_small" in got) == bool(small)
        assert ("images_weak" in got) == async_views
        assert ("spx_small_weak" in got) == bool(small and async_views)
        for k, v in want.items():
            g = got[k]
            if k.startswith("images"):
                assert g.shape == (3, H, W), k
                g = g.transpose(1, 2, 0)
            if isinstance(v, np.ndarray):
                assert g.dtype == v.dtype, k
                np.testing.assert_array_equal(g, v, err_msg=k)
            else:
                assert g == v, k
