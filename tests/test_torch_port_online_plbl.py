"""The port's online pseudo labels (mulactseg_tpu_torch/losses/online.py:
local_proto_plbl, local_proto_ce), utils/schedule.ramp_up and the six
online criteria against the JAX package's, on the same numpy-seeded
inputs.

- local_proto_plbl on one image: the pseudo-label map and the prototype
  source pixels exact, the similarities within 1e-6, with the 256-slot
  cap below the image's (superpixel, class) pairs (5), above them, and on
  an image of 200 superpixels with more than 256 pairs (the first 256 in
  row-major order kept, as jnp.nonzero(size=256) keeps them); chunks of
  100 pixels against JAX's 65,536.
- local_proto_ce with and without weights, and on an all-ignore map (0).
- ramp_up and sigmoid_ramp_up at both sides of x = 1, with dorampup on
  and off.
- The six criteria (and weight_wo_proto, th_wplbl, dorampup) at the loss
  on test_torch_port_criteria.py's batch, with the small twin's train
  logits and eval features: loss and parts within 1e-5 relative, the
  logits gradient within 1e-5 of its largest entry (for the _domc group
  term, outside segments with a near-tie, as test_torch_port_criteria.py
  states).
- Step 0 of the six through make_train_step against the JAX train step
  (tiny model pair): the loss parts within 1e-5 relative, the parameters
  after the AdamW step within 1e-4 relative in L2 over all leaves.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mulactseg_tpu.engine import train as jax_train
from mulactseg_tpu.losses import online as jax_online
from mulactseg_tpu.utils import schedule as jax_schedule
from chip_smoke import near_tie_pixels
from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
from mulactseg_tpu_torch.engine.train import CRITERIA, make_train_step
from mulactseg_tpu_torch.losses import online
from mulactseg_tpu_torch.utils import schedule
from tests.test_torch_port_criteria import (
    B,
    CT,
    NSEG,
    configs,
    region_batch,
    softmax_planes,
    twin_forwards,
    valid_ids,
)
from tests.test_torch_port_criteria_step import (
    _images,
    _jax_state,
    _jbatch,
    _params_tree,
    tiny_pair,
)
from tests.test_torch_port_train import _global_rel

torch.set_num_threads(1)

H, W = 32, 24


def image_inputs(rng, h, w, nseg, ct=CT):
    """One image's normalised features (P, 8), softmax (P, ct), multi-hot
    targets (nseg, ct) (empty, one-hot or 2-3 classes), spx and spmask."""
    P = h * w
    feats = rng.randn(P, 8).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    probs = torch.softmax(torch.from_numpy(rng.randn(P, ct).astype(
        np.float32)), dim=1).numpy()
    target = np.zeros((nseg, ct), np.float32)
    for s in range(nseg):
        n = (0, 1, rng.randint(2, 4))[rng.choice(3, p=[0.15, 0.25, 0.6])]
        target[s, rng.choice(ct, n, replace=False)] = 1.0
    spx = irregular_superpixels(h, w, nseg, rng).reshape(-1)
    spmask = (rng.rand(nseg) < 0.8)[spx]
    return feats, probs, target, spx.astype(np.int32), spmask


def candidate_pairs(target, spx, spmask):
    """The (selected multi-hot superpixel, candidate class) pairs."""
    present = np.zeros(len(target), bool)
    present[spx[spmask]] = True
    return int((target[(target.sum(-1) > 1) & present] > 0.5).sum())


@pytest.mark.parametrize("h,w,nseg,max_protos", [
    (H, W, NSEG, 5), (H, W, NSEG, 256), (64, 64, 300, 256)],
    ids=["cap5", "cap256", "over256"])
def test_local_proto_plbl_matches_jax(h, w, nseg, max_protos):
    rng = np.random.RandomState(nseg + max_protos)
    args = image_inputs(rng, h, w, nseg)
    pairs = candidate_pairs(*args[2:])
    assert (pairs > max_protos) == (max_protos != 256 or nseg == 300)
    plbl, sim, src = online.local_proto_plbl(
        *(torch.from_numpy(a) for a in args), nseg=nseg,
        max_protos=max_protos, chunk=100)
    jp, js, jsrc = jax_online.local_proto_plbl(
        *(jnp.asarray(a) for a in args), nseg=nseg, max_protos=max_protos)
    np.testing.assert_array_equal(plbl.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_allclose(sim.numpy(), np.asarray(js), rtol=0,
                               atol=1e-6)
    assert 0 < (plbl.numpy() != 255).sum() < h * w
    assert 0 < int(src.sum()) <= min(max_protos, pairs)


def test_prototype_candidates_count_the_pairs():
    rng = np.random.RandomState(1)
    args = image_inputs(rng, 64, 64, 300)
    pr = online.prototypes(*(torch.from_numpy(a) for a in args), nseg=300)
    assert int(pr.candidates) == candidate_pairs(*args[2:]) > 256
    assert int(pr.ok.sum()) == 256


@pytest.mark.parametrize("weighted,empty", [(False, False), (True, False),
                                            (False, True)])
def test_local_proto_ce_matches_jax(weighted, empty):
    rng = np.random.RandomState(3)
    logits = rng.randn(B, CT, H, W).astype(np.float32)
    plbl = rng.randint(0, CT, (B, H, W)).astype(np.int32)
    plbl[rng.rand(B, H, W) < (1.0 if empty else 0.4)] = 255
    w = rng.rand(B, H, W).astype(np.float32) if weighted else None
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss = online.local_proto_ce(
        lt, torch.from_numpy(plbl), temp=0.1,
        weights=None if w is None else torch.from_numpy(w))
    loss.backward()
    jl, jg = jax.jit(jax.value_and_grad(lambda lg: jax_online.local_proto_ce(
        lg, jnp.asarray(plbl), temp=0.1,
        weights=None if w is None else jnp.asarray(w))))(
        jnp.asarray(logits.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5,
                               atol=0 if not empty else 1e-30)
    assert (float(jl) == 0.0) == empty
    want = np.asarray(jg).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(lt.grad.numpy(), want, rtol=0,
                               atol=1e-6 * max(np.abs(want).max(), 1e-30))


def test_ramp_up_matches_jax():
    for x in (0.0, 0.01, 0.25, 0.999, 1.0, 1.5):
        for lamparam, scale in ((0.1, 1.0), (0.3, 2.0)):
            for on in (True, False):
                assert schedule.ramp_up(x, lamparam, scale, on) == \
                    jax_schedule.ramp_up(x, lamparam, scale, on)
            assert schedule.sigmoid_ramp_up(x, lamparam, scale) == \
                jax_schedule.sigmoid_ramp_up(x, lamparam, scale)
    assert schedule.ramp_up(2.0) == 1.0 and schedule.ramp_up(0.0) == 0.0


# (case id, method, Config overrides)
ONLINE = [
    ("plbl", "active_onlineplbl_multi_predignore", {}),
    ("wplbl", "active_onlinewplbl_multi_predignore", {}),
    ("wplbl_woproto", "active_onlinewplbl_multi_predignore",
     {"weight_wo_proto": True}),
    ("simwplbl", "active_onlinesimwplbl_multi_predignore",
     {"dorampup": True}),
    ("simwplbl_th", "active_onlinesimwplbl_multi_predignore",
     {"th_wplbl": 0.3}),
    ("wplblonly", "active_onlinewplblonly_multi_predignore", {}),
    ("plbl_domc", "active_onlineplbl_multi_predignore_domc",
     {"dorampup": True, "lamparam": 0.3}),
    ("simwplbl_domc", "active_onlinesimwplbl_multi_predignore_domc", {}),
]


@pytest.mark.parametrize("case,method,over", ONLINE,
                         ids=[c[0] for c in ONLINE])
def test_online_criterion_matches_jax(case, method, over):
    rng = np.random.RandomState(len(case))
    batch = region_batch(rng)
    images = rng.randn(B, 3, H, W).astype(np.float32)
    logits, feat, plbl = twin_forwards(len(case), images)
    cfg, jcfg = configs(method, over)
    crit = CRITERIA[method](cfg)
    lt = torch.from_numpy(logits).requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, aux = crit(lt, tb, {"feat": torch.from_numpy(feat),
                               "plbl_logits": torch.from_numpy(plbl),
                               "frac": 0.25})
    total.backward()
    jcrit = jax_train.CRITERIA[method](jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jextra = {"feat": jnp.asarray(feat.transpose(0, 2, 3, 1)),
              "plbl_logits": jnp.asarray(plbl.transpose(0, 2, 3, 1)),
              "frac": jnp.float32(0.25)}
    (jt, jaux), jg = jax.jit(jax.value_and_grad(
        lambda lg: jcrit(lg, jb, jextra), has_aux=True))(
        jnp.asarray(logits.transpose(0, 2, 3, 1)))
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(jaux["local_proto_loss"]) > 0.0
    got = lt.grad.numpy()
    want = np.asarray(jg).transpose(0, 3, 1, 2)
    bad = np.abs(got - want) > 1e-5 * np.abs(want).max()
    if bad.any():  # only the _domc group term picks argmax pixels
        assert "domc" in case
        ties = near_tie_pixels(softmax_planes(logits), valid_ids(
            batch, only_multi=True), NSEG).numpy()
        assert not (bad.any(axis=1).reshape(B, -1) & ~ties).any()


@pytest.mark.parametrize("case,method,over", ONLINE,
                         ids=[c[0] for c in ONLINE])
def test_step0_matches_jax_train_step(case, method, over):
    rng = np.random.RandomState(300 + len(case))
    batch = region_batch(rng)
    batch["images"] = _images(rng)
    cfg, jcfg = configs(method, dict(over, train_lr=1e-2))
    port, ref, v = tiny_pair(CT, len(case))
    step = make_train_step(port, cfg, device="cpu")
    aux = step(batch)
    jstep = jax_train.make_train_step(ref, jcfg, donate=False)
    state, jaux = jstep(_jax_state(ref, jcfg, v), _jbatch(batch),
                        jax.random.PRNGKey(0))
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    err = _global_rel(_params_tree(port), state.params)
    assert err < 1e-4, err
    assert _global_rel(v["params"], state.params) > 20 * err
