"""The port's train step with the criteria added beside the recipes',
against the JAX package's train step; its optimizers against optax; the
registries; the resume of a reference-layout checkpoint.

- Step 0 of make_train_step for each criterion (the ablation with
  rand_multi_ce on one-hot targets, where its pick is forced) and the
  unfused lossdecomp, against the JAX make_train_step's loss parts, on a
  tiny model twin (a 3x3 conv, BN and ReLU as the backbone, a biased 1x1
  final as the head, wrapped in each package's DeepLabV3), so that the
  needs_feat criteria run both forwards: within 1e-5 relative.
- The eval-mode forward of a needs_feat step leaves the BN running
  statistics and the dropout generator as a plain train forward leaves
  them (bitwise).
- 3 SGD steps (poly and constant schedules) and 3 AdamW steps at the
  constant schedule against optax: parameters within 1e-4 relative (L2
  over all leaves, as test_torch_port_train.py's AdamW test).
- rand_multi_ce: a fixed generator repeats; its picks are uniform over
  each pixel's candidates (chi-square over 4,608 draws at 3 candidates,
  below the 0.1% critical value 13.8 for 2 degrees of freedom).
- focal_loss, rcce, rcce_asym and the six LOSS_TYPES but the hierarchy
  ones (test_torch_port_hier.py holds those) against the
  JAX package: within 1e-5 relative, gradients within 1e-5 of the
  largest entry (for the group term, outside segments with a near-tie,
  as test_torch_port_criteria.py states), on N(0, 0.2^2) logits.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch
import torch.nn as nn

from mulactseg_tpu.config import Config as JaxConfig
from mulactseg_tpu.engine import train as jax_train
from mulactseg_tpu.engine.state import create_train_state
from mulactseg_tpu.models.deeplab import DeepLabV3 as JaxDeepLab
from mulactseg_tpu.models.layers import batch_norm as jax_bn
from mulactseg_tpu.models.layers import conv as jax_conv
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.engine import train as port_train
from mulactseg_tpu_torch.engine.train import make_train_step
from mulactseg_tpu_torch.models.deeplab import DeepLabV3
from mulactseg_tpu_torch.models.layers import Conv2d, Dropout, FastBatchNorm
from chip_smoke import near_tie_pixels
from tests.test_torch_port_criteria import (
    CASES,
    CT,
    NSEG,
    SLICED,
    configs,
    region_batch,
    softmax_planes,
    valid_ids,
)
from tests.test_torch_port_train import _global_rel

torch.set_num_threads(1)

B, H, W = 2, 32, 24


class _Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = Conv2d(3, 8, 3)
        self.bn = FastBatchNorm(8)
        self.drop = Dropout(0.0)

    def forward(self, x):
        return {"out": self.drop(torch.relu(self.bn(self.conv(x))))}


class _Head(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.final = Conv2d(8, c, 1, bias=True, fan_mode="fan_in")

    def forward(self, feats, return_feat=False):
        y = feats["out"]
        return (y, self.final(y)) if return_feat else self.final(y)


class _JaxBackbone(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        y = jax_bn(train, name="bn")(jax_conv(8, 3, name="conv")(x))
        return {"out": fnn.relu(y)}


class _JaxHead(fnn.Module):
    num_classes: int

    @fnn.compact
    def __call__(self, feats, train=False, return_feat=False):
        y = feats["out"]
        logits = jax_conv(self.num_classes, 1, use_bias=True,
                          name="final")(y)
        return (y, logits) if return_feat else logits


def tiny_pair(c, seed):
    """(port model, flax model, flax variables) with the same weights and
    BN statistics moved off their defaults."""
    ref = JaxDeepLab(backbone=_JaxBackbone(), classifier=_JaxHead(c))
    v = ref.init(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)),
                 train=False)
    rng = np.random.RandomState(seed)
    p = jax.tree_util.tree_map(np.asarray, dict(v["params"]))
    bs = {"backbone": {"bn": {
        "mean": rng.uniform(-0.1, 0.1, 8).astype(np.float32),
        "var": rng.uniform(0.8, 1.2, 8).astype(np.float32)}}}
    port = DeepLabV3(_Backbone(), _Head(c))
    hwio = lambda k: torch.from_numpy(np.ascontiguousarray(
        np.transpose(k, (3, 2, 0, 1))))
    sd = {"backbone.conv.weight": hwio(p["backbone"]["conv"]["kernel"]),
          "backbone.bn.weight": torch.from_numpy(p["backbone"]["bn"]["scale"]),
          "backbone.bn.bias": torch.from_numpy(p["backbone"]["bn"]["bias"]),
          "backbone.bn.running_mean": torch.from_numpy(
              bs["backbone"]["bn"]["mean"]),
          "backbone.bn.running_var": torch.from_numpy(
              bs["backbone"]["bn"]["var"]),
          "classifier.final.weight": hwio(p["classifier"]["final"]["kernel"]),
          "classifier.final.bias": torch.from_numpy(
              p["classifier"]["final"]["bias"])}
    port.load_state_dict(sd, strict=True)
    return port, ref, {"params": p, "batch_stats": bs}


def _params_tree(port):
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    oihw = lambda w: np.transpose(w, (2, 3, 1, 0))
    return {"backbone": {"conv": {"kernel": oihw(sd["backbone.conv.weight"])},
                         "bn": {"scale": sd["backbone.bn.weight"],
                                "bias": sd["backbone.bn.bias"]}},
            "classifier": {"final": {
                "kernel": oihw(sd["classifier.final.weight"]),
                "bias": sd["classifier.final.bias"]}}}


def _images(rng, n=B):
    return (rng.randn(n, 3, H, W) * np.linspace(0.5, 2.0, n)[
        :, None, None, None]).astype(np.float32)


def _jax_state(ref, jcfg, v, steps=None):
    state = create_train_state(ref, jcfg, jax.random.PRNGKey(0),
                               (B, H, W, 3), total_itrs=steps)
    return state.replace(params=v["params"], batch_stats=v["batch_stats"],
                         opt_state=state.tx.init(v["params"]))


def _jbatch(batch):
    return {k: jnp.asarray(x.transpose(0, 2, 3, 1) if k == "images" else x)
            for k, x in batch.items()}


STEP_CASES = [c for c in CASES
              if c[0] not in ("ablation_rc", "ablation_max")]


@pytest.mark.parametrize("case,method,over", STEP_CASES,
                         ids=[c[0] for c in STEP_CASES])
def test_step0_matches_jax_train_step(case, method, over):
    rng = np.random.RandomState(100 + len(case))
    batch = region_batch(rng, one_hot_only=case == "ablation_rand")
    batch["images"] = _images(rng)
    cfg, jcfg = configs(method, over)
    c = CT - 1 if method in SLICED else CT
    port, ref, v = tiny_pair(c, len(case))
    step = make_train_step(port, cfg, device="cpu")
    aux = step(batch)
    jstep = jax_train.make_train_step(ref, jcfg, donate=False)
    _, jaux = jstep(_jax_state(ref, jcfg, v), _jbatch(batch),
                    jax.random.PRNGKey(0))
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(jaux["train_loss"]) > 0.0
    assert step.step == 1


def test_eval_forward_leaves_bn_statistics_and_dropout_alone():
    """A needs_feat step (wgroup) runs its eval-mode forward before the
    train forward: the BN running statistics and the dropout generator
    end where a step without it (the joint criterion, same weights and
    batch) leaves them, and the model is in train mode afterwards."""
    rng = np.random.RandomState(3)
    batch = region_batch(rng)
    batch["images"] = _images(rng)
    ends = []
    for method in ("active_joint_multi_predignore_wgroup",
                   "active_joint_multi_predignore"):
        port, _, _ = tiny_pair(CT, 1)
        port.backbone.drop.p = 0.5
        gen = torch.Generator().manual_seed(0)
        cfg, _ = configs(method, {})
        make_train_step(port, cfg, device="cpu", generator=gen)(batch)
        assert port.training
        ends.append((port.backbone.bn.running_mean.clone(),
                     port.backbone.bn.running_var.clone(), gen.get_state()))
    for a, b in zip(*ends):
        assert torch.equal(a, b)


@pytest.mark.parametrize("optimizer,scheduler", [
    ("sgd", "poly"), ("sgd", "constant"), ("adamw", "constant")])
def test_three_steps_match_optax(optimizer, scheduler):
    method = "active_joint_multi_predignore"
    over = dict(optimizer=optimizer, scheduler=scheduler, train_lr=1e-2,
                cls_lr_scale=10.0, weight_decay=5e-4, finetune_itrs=3,
                min_lr=1e-3)
    cfg, jcfg = configs(method, over)
    port, ref, v = tiny_pair(CT, 9)
    step = make_train_step(port, cfg, device="cpu")
    state = _jax_state(ref, jcfg, v)
    jstep = jax_train.make_train_step(ref, jcfg, donate=False)
    rng = np.random.RandomState(9)
    for it in range(3):
        batch = region_batch(rng)
        batch["images"] = _images(rng)
        step(batch)
        state, _ = jstep(state, _jbatch(batch), jax.random.PRNGKey(it))
    lrs = [g["lr"] for g in step.optimizer.param_groups]
    if scheduler == "constant":
        assert lrs == [1e-2, 1e-1]  # no min_lr floor, head at 10x
    got = _params_tree(port)
    err = _global_rel(got, state.params)
    assert err < 1e-4, err
    assert _global_rel(v["params"], state.params) > 20 * err


def test_rand_multi_ce_repeats_and_draws_uniformly():
    from mulactseg_tpu_torch.losses.partial import rand_multi_choice_ce

    rng = np.random.RandomState(4)
    batch = region_batch(rng)
    tb = {k: torch.from_numpy(batch[k]) for k in ("target", "spx", "spmask")}
    logits = torch.from_numpy(rng.randn(B, CT - 1, H, W).astype(np.float32))
    runs = [float(rand_multi_choice_ce(logits, *tb.values(),
                                       torch.Generator().manual_seed(s)))
            for s in (7, 7, 8)]
    assert runs[0] == runs[1] != runs[2]

    # one pixel, three candidates: which class each draw picks, read from
    # the loss (-log p of the picked class, with distinct p)
    target = torch.zeros(1, 1, 5)
    target[0, 0, [0, 2, 3]] = 1.0
    lg = torch.tensor([0.0, 5.0, 0.7, 1.4]).reshape(1, 4, 1, 1)
    spx = torch.zeros(1, 1, 1, dtype=torch.int32)
    spmask = torch.ones(1, 1, 1, dtype=torch.bool)
    p = torch.softmax(lg.reshape(4), dim=0)
    want = {round(float(-torch.log(p[c] + 1e-8) / 2.0), 5): c
            for c in (0, 2, 3)}
    gen = torch.Generator().manual_seed(0)
    counts = {0: 0, 2: 0, 3: 0}
    n = 4608
    for _ in range(n):
        loss = float(rand_multi_choice_ce(lg, target, spx, spmask, gen))
        counts[want[round(loss, 5)]] += 1
    chi2 = sum((k - n / 3) ** 2 / (n / 3) for k in counts.values())
    assert chi2 < 13.8, counts


def test_dense_losses_and_loss_types_match_jax():
    from mulactseg_tpu.losses import registry as jax_registry
    from mulactseg_tpu.losses import standard as jax_standard
    from mulactseg_tpu_torch.losses import registry, standard

    rng = np.random.RandomState(5)
    C = CT - 1
    # N(0, 0.2^2) logits: at N(0, 1) the T = 0.1 softmax saturates and
    # each package's float32 group-term gradient strays from float64 by
    # up to 3.1e-4 of its largest entry, past the 1e-5 held here
    # (test_torch_port_criteria.test_group_term_float32_against_float64)
    logits = (rng.randn(B, C, H, W) * 0.2).astype(np.float32)
    weak = rng.randn(B, C, H, W).astype(np.float32)
    labels = rng.randint(0, C, (B, H, W)).astype(np.int32)
    labels[rng.rand(B, H, W) < 0.2] = 255
    maps = (rng.rand(B, C + 1, H, W) < 0.3).astype(np.float32)
    batch = region_batch(rng)
    batch["labels"] = labels
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))

    def check(port_fn, jax_fn, group=False):
        lt = torch.from_numpy(logits).requires_grad_(True)
        out = port_fn(lt)
        outs = out if isinstance(out, tuple) else (out,)
        sum(outs).backward()
        def jf(lg):
            out = jax_fn(lg)
            out = out if isinstance(out, tuple) else (out,)
            return sum(out), out

        (_, jouts), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
            nhwc(logits))
        for a, b in zip(outs, jouts):
            np.testing.assert_allclose(float(a.detach()), float(b),
                                       rtol=1e-5)
        want = np.asarray(jg).transpose(0, 3, 1, 2)
        bad = np.abs(lt.grad.numpy() - want) > 1e-5 * np.abs(want).max()
        if group:  # a near-tie may move the group term's argmax
            bad = bad.any(axis=1).reshape(B, -1) & ~near_tie_pixels(
                softmax_planes(logits), valid_ids(batch), NSEG).numpy()
        assert not bad.any(), int(bad.sum())

    for gamma in (0.0, 2.0):
        check(lambda lg: standard.focal_loss(
            lg, torch.from_numpy(labels), gamma=gamma, alpha=0.5),
            lambda lg: jax_standard.focal_loss(
                lg, jnp.asarray(labels), gamma=gamma, alpha=0.5))
    check(lambda lg: standard.rcce(lg, torch.from_numpy(maps), temp=0.5),
          lambda lg: jax_standard.rcce(lg, nhwc(maps), temp=0.5))
    check(lambda lg: standard.rcce_asym(lg, torch.from_numpy(weak),
                                        torch.from_numpy(maps), temp=0.5,
                                        temp_w=2.0),
          lambda lg: jax_standard.rcce_asym(lg, nhwc(weak), nhwc(maps),
                                            temp=0.5, temp_w=2.0))
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    tb.update(logits_weak=torch.from_numpy(weak),
              target_maps=torch.from_numpy(maps))
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    jb.update(logits_weak=nhwc(weak), target_maps=nhwc(maps))
    assert list(registry.LOSS_TYPES) == list(jax_registry.LOSS_TYPES)
    ported = [k for k in registry.LOSS_TYPES if "hier" not in k]
    assert len(ported) == 6
    for name in ported:
        kw = dict(num_classes=C, nseg=NSEG, loss_type=name,
                  loader="synthetic")
        fn = registry.get_loss_type(Config(**kw))
        jfn = jax_registry.get_loss_type(JaxConfig(**kw))
        check(lambda lg: fn(lg, tb), lambda lg: jfn(lg, jb),
              group="group" in name or "joint" in name)
    for name in ("hierarchy_group_multi_label_ce",
                 "joint_hierarchy_multi_loss"):  # test_torch_port_hier.py
        assert callable(registry.get_loss_type(Config(loss_type=name)))


def test_criteria_registry_follows_jax_order():
    """All 32 criteria, in the JAX package's order, active_slide
    among them."""
    assert "active_slide" in port_train.CRITERIA
    assert len(port_train.CRITERIA) == len(jax_train.CRITERIA) == 32
    assert list(port_train.CRITERIA) == list(jax_train.CRITERIA)
    assert callable(port_train.get_criterion(Config(method="active_slide")))
    with pytest.raises(KeyError, match="available"):
        port_train.get_criterion(Config(method="not_a_method"))


def test_reference_checkpoint_resumes_its_optimizer_state(tmp_path):
    """A payload in the reference's layout ('opt_state_dict', no step)
    restores the optimizer's moments; the port's own key still works."""
    from mulactseg_tpu_torch.engine.rounds import ALTrainer

    cfg = configs("active_joint_multi_predignore",
                  {"model_save_dir": str(tmp_path)})[0]
    rng = np.random.RandomState(6)
    batch = region_batch(rng)
    batch["images"] = _images(rng)
    src = ALTrainer(cfg, 1, model=tiny_pair(CT, 2)[0], device="cpu")
    src.train_step(batch)
    state = src.optimizer.state_dict()
    assert state["state"]  # AdamW moments exist after a step
    for key in ("opt_state_dict", "optimizer_state_dict"):
        path = tmp_path / f"ckpt_{key}"
        torch.save({"model_state_dict": src.model.state_dict(), key: state},
                   path)
        dst = ALTrainer(cfg, 1, model=tiny_pair(CT, 3)[0], device="cpu")
        dst.load(str(path), strip_classifier=False)
        got = dst.optimizer.state_dict()["state"]
        assert got.keys() == state["state"].keys()
        for i in got:
            for name in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(got[i][name], state["state"][i][name])
        assert dst.step == 0


@pytest.mark.parametrize("max_protos", [5, 256])
def test_prototype_weights_keep_the_first_prototypes_as_jax(max_protos):
    """pwce's prototype weights against the JAX package's, with the cap
    below the image's (superpixel, class) pairs (the first max_protos in
    row-major order kept, the rest dropped) and above them; chunks of 100
    pixels against JAX's 65,536 (the chunking is free). Within 1e-5."""
    from mulactseg_tpu.losses.online import (
        prototype_weight_targets as jax_weights,
    )
    from mulactseg_tpu_torch.losses.online import prototype_weight_targets

    rng = np.random.RandomState(max_protos)
    batch = region_batch(rng)
    P = H * W
    feats = rng.randn(P, 8).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    probs = torch.softmax(torch.from_numpy(rng.randn(P, CT).astype(
        np.float32)), dim=1).numpy()
    args = (batch["target"][0], batch["spx"][0].reshape(-1),
            batch["spmask"][0].reshape(-1))
    multi = batch["target"][0].sum(-1) > 1
    assert (batch["target"][0][multi] > 0).sum() > 5  # the cap bites at 5
    got = prototype_weight_targets(
        torch.from_numpy(feats), torch.from_numpy(probs),
        *(torch.from_numpy(a) for a in args), nseg=NSEG, simw_temp=0.1,
        max_protos=max_protos, chunk=100)
    want = jax_weights(jnp.asarray(feats), jnp.asarray(probs),
                       *(jnp.asarray(a) for a in args), nseg=NSEG,
                       simw_temp=0.1, max_protos=max_protos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
