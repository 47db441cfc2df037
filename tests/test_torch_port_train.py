"""The port's stage-1 loss and train step against the JAX package.

- lossdecomp_fused (loss, its three parts and the logits gradient) against
  JAX lossdecomp_fused(nchw=True) at 32x32 and at an odd 33x31 (which
  the JAX package zero-pads and the port does not): rtol 1e-5, gradient
  atol 1e-5 of its largest entry (float32 sums in another order).
- Three make_train_step steps (AdamW, two groups, poly LR, train-mode BN)
  on the small model twin against JAX create_train_state +
  make_train_step: step-0 loss to 1e-5 relative, the parameters and the
  BN statistics after 3 steps to 1e-4 relative (L2 over all leaves).
  Dropout is off on both sides (flax nn.Dropout patched to identity in
  this test only), since its noise is framework-specific. Why the norm is
  taken over all leaves and the LR is 1e-4: Adam's first step moves each
  element by about lr * sign(g), so an element whose gradient lies within
  float32 noise of 0 (train-mode BN's single-pass variance cancels on both
  sides) steps the other way. The step-0 gradients agree to ~1e-4 per
  tensor, yet ~15 of 1.1M elements flip; each flip costs 2 * lr, which
  exceeds 1e-4 of a small tensor's norm but not of the whole vector.
- The optimizer alone, fed the same gradients as optax: atol 5e-6.
- The port's copies of the synthetic superpixel maker and the bitmask
  packer give the JAX package's exact outputs.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import optax
import torch

from mulactseg_tpu.config import Config as JaxConfig
from mulactseg_tpu.data.synthetic import (
    irregular_superpixels as jax_irregular_superpixels,
)
from mulactseg_tpu.engine.state import create_train_state
from mulactseg_tpu.engine.train import make_train_step as jax_make_train_step
from mulactseg_tpu.losses.fused import lossdecomp_fused as jax_lossdecomp
from mulactseg_tpu.losses.fused import pixel_target_bits as jax_bits
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
from mulactseg_tpu_torch.engine.train import CRITERIA, get_criterion
from mulactseg_tpu_torch.engine.train import make_train_step
from mulactseg_tpu_torch.losses.fused import (
    bits_to_multihot,
    lossdecomp_fused,
    pixel_target_bits,
)
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.models.layers import Dropout
from tests.test_torch_port_model import jax_variables, twin_pair

torch.set_num_threads(1)


def make_batch(rng, B, H, W, C, nseg):
    """bench.py-style batch: irregular superpixels, multi-hot 15% (plus
    one class, so every segment has a candidate), 60% selection."""
    spx = np.stack([irregular_superpixels(H, W, nseg, rng)
                    for _ in range(B)]).astype(np.int32)
    target = (rng.rand(B, nseg, C) < 0.15).astype(np.float32)
    target[np.arange(B)[:, None], np.arange(nseg)[None, :],
           rng.randint(0, C, (B, nseg))] = 1.0
    sel = rng.rand(B, nseg) < 0.6
    spmask = np.take_along_axis(sel, spx.reshape(B, -1), 1).reshape(B, H, W)
    bits = np.stack([pixel_target_bits(target[b], spx[b], spmask[b])
                     for b in range(B)])
    # per-image scale and offset keep every BN's batch variance (the ASPP
    # pooling branch normalises B pooled values) well above the float32
    # cancellation of the single-pass E[x^2] - m^2 that both sides use
    images = (rng.randn(B, H, W, 3) * np.linspace(0.5, 2.0, B)[:, None, None, None]
              + np.linspace(-2.0, 2.0, B)[:, None, None, None]
              ).astype(np.float32)
    return {"images": images.transpose(0, 3, 1, 2).copy(),
            "target": target, "target_bits": bits, "spx": spx}


@pytest.mark.parametrize("H,W", [(32, 32), (33, 31)])
def test_lossdecomp_fused_matches_jax(H, W):
    rng = np.random.RandomState(H * W)
    B, C, nseg = 2, 20, 16
    batch = make_batch(rng, B, H, W, C, nseg)
    logits = (rng.randn(B, C, H, W) * 3).astype(np.float32)
    kw = dict(nseg=nseg, coeff=16.0, coeff_mc=8.0, coeff_gm=1.0,
              multi_ce_temp=0.1, group_ce_temp=0.1)

    lt = torch.from_numpy(logits).requires_grad_(True)
    total, aux = lossdecomp_fused(
        lt, torch.from_numpy(batch["target_bits"]),
        torch.from_numpy(batch["target"]), torch.from_numpy(batch["spx"]),
        **kw)
    total.backward()

    def f(lg):
        return jax_lossdecomp(lg, jnp.asarray(batch["target_bits"]),
                              jnp.asarray(batch["target"]),
                              jnp.asarray(batch["spx"]), nchw=True, **kw)

    (jt, jaux), jg = jax.value_and_grad(f, has_aux=True)(jnp.asarray(logits))
    for k in ("ce_loss", "mc_loss", "group_loss", "train_loss"):
        assert float(aux[k].detach()) > 0.0, k
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                   rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(jt), rtol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(lt.grad.numpy(), jg, rtol=1e-5,
                               atol=1e-5 * np.abs(jg).max())


def _global_rel(got, want):
    """||got - want|| / ||want|| over every leaf of two flax-layout trees."""
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    d = n = 0.0
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        w = np.asarray(w, np.float64)
        d += np.sum((np.asarray(flat[path], np.float64) - w) ** 2)
        n += np.sum(w ** 2)
    return np.sqrt(d / n)


def test_three_train_steps_match_jax(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, **kw: x)
    NC, B, H, nseg, steps = 7, 4, 33, 12, 3
    common = dict(num_classes=NC - 1, nseg=nseg, crop_size=(H, H),
                  train_lr=1e-4, cls_lr_scale=10.0, weight_decay=5e-4,
                  power=0.9, min_lr=1e-6, finetune_itrs=steps,
                  method="active_joint_multi_predignore_lossdecomp",
                  dtype="float32", loader="synthetic")
    cfg, jcfg = Config(**common), JaxConfig(**common)

    port, ref = twin_pair(separable=True)
    v = jax_variables(ref, 7)
    convert.load_variables(port, v)
    for m in port.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    step = make_train_step(port, cfg, device="cpu")

    state = create_train_state(ref, jcfg, jax.random.PRNGKey(0),
                               (B, H, H, 3))
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"],
                          opt_state=state.tx.init(v["params"]))
    jstep = jax_make_train_step(ref, jcfg, donate=False)

    rng = np.random.RandomState(8)
    for it in range(steps):
        batch = make_batch(rng, B, H, H, NC, nseg)
        aux = step(batch)
        jbatch = {k: jnp.asarray(val.transpose(0, 2, 3, 1) if k == "images"
                                 else val) for k, val in batch.items()}
        state, jaux = jstep(state, jbatch, jax.random.PRNGKey(it))
        if it == 0:
            np.testing.assert_allclose(float(aux["train_loss"]),
                                       float(jaux["train_loss"]), rtol=1e-5)
    assert step.step == steps
    got = convert.state_dict_to_variables(port.state_dict())
    err = _global_rel(got["params"], state.params)
    assert err < 1e-4, err
    # the steps moved the parameters by far more than the two sides differ
    assert _global_rel(v["params"], state.params) > 20 * err
    assert _global_rel(got["batch_stats"], state.batch_stats) < 1e-4


def test_optimizer_matches_optax_on_shared_gradients():
    """make_optimizer + set_lr against the JAX package's optax transform
    fed the same gradients: AdamW with decay on every parameter, the head
    group at cls_lr_scale, poly LR at the pre-update step count, and the
    unscaled min_lr floor (reached at the last step). Tolerance atol 5e-6:
    the port agrees with a float64 evaluation of the same updates to
    1e-7, optax's float32 evaluation strays up to 2e-6 from it at these
    learning rates."""
    from mulactseg_tpu.engine.state import make_optimizer as jax_make_opt
    from mulactseg_tpu_torch.engine.state import make_optimizer, set_lr

    steps = 5
    cfg_kw = dict(train_lr=1e-2, cls_lr_scale=10.0, weight_decay=5e-2,
                  power=0.9, min_lr=1e-3, finetune_itrs=steps - 1)
    cfg, jcfg = Config(**cfg_kw), JaxConfig(**cfg_kw)
    rng = np.random.RandomState(0)
    shapes = {"backbone.w": (3, 4), "classifier.w": (5,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(steps)]

    model = torch.nn.Module()
    for part in ("backbone", "classifier"):
        sub = torch.nn.Module()
        sub.w = torch.nn.Parameter(torch.from_numpy(init[f"{part}.w"].copy()))
        model.add_module(part, sub)
    opt = make_optimizer(model, cfg)

    def tree(d):
        return {"backbone": {"w": d["backbone.w"]},
                "classifier": {"w": d["classifier.w"]}}

    tx = jax_make_opt(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree(init))
    opt_state = tx.init(params)
    for it, g in enumerate(grads):
        set_lr(opt, cfg, it)
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(g[name])
        opt.step()
        upd, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, tree(g)), opt_state, params)
        params = optax.apply_updates(params, upd)
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    for name in shapes:
        part = name.split(".")[0]
        np.testing.assert_allclose(got[name], np.asarray(params[part]["w"]),
                                   rtol=0, atol=5e-6, err_msg=name)
    assert opt.param_groups[1]["lr"] == cfg.min_lr  # floor not scaled


def test_criteria_registry():
    assert list(CRITERIA) == [
        "active_joint_multi_predignore_lossdecomp",
        "active_joint_multi_lossdecomp",
        "active_joint_multi_predignore", "active_joint_multi",
        "active_joint_multi_predignore_mclossablation2",
        "active_predignore", "active", "active_slide",
        "active_onlineplbl_multi_predignore",
        "active_onlinewplbl_multi_predignore",
        "active_onlinesimwplbl_multi_predignore",
        "active_onlinewplblonly_multi_predignore",
        "active_onlineplbl_multi_predignore_domc",
        "active_onlinesimwplbl_multi_predignore_domc",
        "active_joint_multi_predignore_precise",
        "active_joint_multi_predignore_multice_precise",
        "active_joint_multi_predignore_multient",
        "active_joint_multi_predignore_exclusivece",
        "active_joint_multi_lossdecomp_rc",
        "active_joint_multi_lossdecomp_topone",
        "active_pwce_multi_predignore",
        "active_joint_multi_predignore_top1plbl",
        "active_joint_multi_predignore_mclossablation",
        "active_joint_multi_predignore_lscale",
        "active_joint_multi_predignore_wgroup",
        "active_joint_hier_multi", "active_joint_hier_multi_async",
        "active_joint_hier_multi_async_weight",
        "active_joint_multi_predignore_mseg",
        "active_joint_multi_ablation",
        "active_joint_multi_predignore_sequence",
        "active_joint_multi_predignore_logprecision"]
    with pytest.raises(KeyError, match="available"):
        get_criterion(Config(method="active_joint_multi_nonexistent"))
    # active_slide trains with plain CE; its sliding window is the
    # validation's (cfg.sliding_eval)
    slide = get_criterion(Config(method="active_slide"))
    plain = get_criterion(Config(method="active"))
    assert slide.keys == plain.keys


def test_synthetic_and_bit_packer_copies_match_jax():
    for seed in (0, 1):
        a = irregular_superpixels(48, 40, 30, np.random.RandomState(seed))
        b = jax_irregular_superpixels(48, 40, 30,
                                      np.random.RandomState(seed))
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(2)
    target = (rng.rand(30, 20) < 0.3).astype(np.float32)
    spx = irregular_superpixels(48, 40, 30, rng)
    spx[0, :5] = 30  # crop-pad id
    spmask = rng.rand(48, 40) < 0.5
    spmask[0, :5] = False
    np.testing.assert_array_equal(pixel_target_bits(target, spx, spmask),
                                  jax_bits(target, spx, spmask))
    mh = bits_to_multihot(torch.from_numpy(
        pixel_target_bits(target, spx, spmask)), 20).numpy()
    np.testing.assert_array_equal(
        mh, np.where(spmask[..., None], target[np.minimum(spx, 29)], 0.0))
