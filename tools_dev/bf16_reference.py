"""The JAX package's dtype=bfloat16 recipe paths as reference files for
the port's bf16 paths on the card, which has no JAX.

Writes tests/data/bf16_reference.npz and bf16_reference_voc.npz, each
fixture to its file of chip_smoke.BF16_FILES. Three fixtures (chip_smoke.
BF16_FIXTURES): "full", the Cityscapes recipe's model
(deeplabv3pluswn_resnet50deepstem, separable, 20 outputs, OS16) at
batch 4, 96x96, nseg 24; "twin", the CPU tests' small twin
(chip_smoke.rp_model's shapes) at batch 4, 64x64, nseg 16; "voc", the
VOC recipe's model (21 outputs, no predignore class) at batch 4, 97x97
(odd, as VOC's 513x513 is), nseg 48, with the recipe's criterion,
selector and flags (chip_smoke.BF16_RECIPES). Weights (chip_smoke.bf16_variables: models/convert's
numpy init with the BN leaves moved off their defaults and each
residual block's last BN scale at a tenth) and inputs
(chip_smoke.bf16_inputs: numpy, irregular superpixels) come from seeds
alone, so the card rebuilds them; the file keeps a digest of the
weights. The JAX package runs with cfg.dtype = "bfloat16" through its
own entry points: the model as engine/rounds.py:52-61 builds it
(mulactseg_tpu.models.get_model for "full"), make_eval_step,
make_train_step for chip_smoke.BF16_STEPS steps on bf16 images (as
engine/rounds.py:186-199 casts them; the recipe's criterion, AdamW,
poly), PseudoLabelGenerator.generate (cosprop_includeonehot, sim_bf16
on; for VOC with use_tta, the recipe's 10-view TTA, whose eager
forward each view's stem and decoder are recorded from) and the
recipe's selector on a pool of 4 images; for VOC also stage 2's step 0
(CE on the pseudo-labels) and the step-0 gradient on a 2-device mesh.
Dropout is off (its noise is framework-specific).

Stored per fixture (chip_smoke.bf16_port_outputs computes the same
keys on the port): the eval-mode logits and normalised features (at a
seeded sample of pixels), the predignore argmax map and its confusion
matrix (over the real classes); the train-mode logits and the change
of the BN running
statistics after one train-mode forward; the step-0 loss and its
parts; the step-0 gradient (at a seeded sample of its values, and its
norm per leaf); the losses of steps 0-2; the norm per leaf of the
parameters' update over the 3 steps; the pseudo-label maps and each
pixel's decision margin (chip_smoke.decision_margins of the JAX
features); the selector's region scores and selected regions; each
stage's output (stem, layer1-4, ASPP, the decoder before the head) in
eval and train mode, at a seeded sample of its values. For VOC also:
the stem and decoder output of each TTA view of the first
pseudo-labelled image ('stage_tta/<scale>[f]/<stage>'); stage 2's
step-0 loss and gradient norm per leaf, trained on the unperturbed
run's pseudo-labels in every run; and under 'world2/' (world2_outputs,
unperturbed) the 2-device step-0 gradient's sample, norms per leaf and
loss, and its cosine and relative L2 distance to the 1-device one.

The JAX package's own spread: the same run with one bf16 ulp added to
or taken from the three channels of a seeded 1% of the input pixels
(every image the model reads), and with every parameter scaled by
1 + 1e-3 N(0, 1), 16 seeds of each (PERTURB_SEEDS). For every float
output 'spread_input/<key>' and 'spread_weights/<key>' are the largest
chip_smoke.bf16_distance of a perturbed run from the unperturbed one;
for every exact output 'flips/<key>' marks the pixels or regions that
any perturbed run changes, and 'novel/<key>' is the most of them one
run changes that no other run does: what one more run of the
reference's own noise adds to a flip set of finitely many runs. The
tolerances (chip_smoke.BF16_TOL) are TOL_FACTOR times the input spread,
rounded up to two significant digits; this script prints them. The
weight scaling moves a quarter of the weights' bf16 values by an ulp,
more than an implementation that rounds in another order does, so its
spread (about twice the input's on the eval outputs) is kept for the
record only.

Run: python tools_dev/bf16_reference.py [--out FILE] [--fixtures full
twin voc] (on 8 CPU cores ~14 min for full and twin, most of it the
full-width perturbed runs, ~20 min for voc). With --world2 it prints,
per fixture, the JAX package's own step-0 gradient on 1 host device
against 2 (world2_gradient) instead (~1 min); with --search, the
train_spread of SEARCH's entries of the fixtures, those tried before
the residual scale and VOC's nseg were chosen (--search-seeds
perturbations of each kind, 3 by default; ~12 min for twin and full,
~5 min for voc at 3). XLA runs with the CPU tests' flags
(tests/conftest.py: 8 host devices, optimisation level 0), under which
tests/test_torch_port_bf16_reference.py regenerates the twin's part.
"""

import argparse
import contextlib
import functools
import math
import os
import sys
import tempfile
import time
from types import SimpleNamespace
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the port's side of the fixtures)

PERTURB_SEEDS = tuple(range(1, 17))
WEIGHT_EPS, INPUT_FRAC, TOL_FACTOR = 1e-3, 0.01, 2.0
# the twin's stages, by the JAX module whose input (or output) each is
STAGE_INPUTS = {"layer1_0": "stem", "layer2_0": "layer1",
                "layer3_0": "layer2", "layer4_0": "layer3"}
STAGE_OUTPUTS = {"aspp": "aspp", "cls1": "decoder"}


def jax_model(name):
    """The JAX package's model of the fixture at dtype=jnp.bfloat16."""
    import jax.numpy as jnp

    if name == "twin":
        from mulactseg_tpu.models.deeplab import DeepLabHeadV3Plus, DeepLabV3
        from mulactseg_tpu.models.resnet import ResNet

        return DeepLabV3(
            backbone=ResNet(layers=(2, 2, 2, 2), deep_stem=True,
                            stem_width=16,
                            replace_stride_with_dilation=(False, False, True),
                            stage_planes=(16, 32, 64, 128),
                            dtype=jnp.bfloat16),
            classifier=DeepLabHeadV3Plus(
                cs.RP_CLASSES, (6, 12, 18), variant="wn", separable=True,
                low_channels=12, mid_channels=64, dtype=jnp.bfloat16))
    from mulactseg_tpu.models import get_model

    cfg = jax_config(name)
    return get_model(cfg.model, num_classes=cfg.num_model_classes,
                     output_stride=cfg.output_stride,
                     separable_conv=cfg.separable_conv, dtype=jnp.bfloat16)


def jax_config(name, stage=None):
    from mulactseg_tpu.config import Config

    return Config(**cs.bf16_config_kw(name, stage))


def bump(images, seed, frac=INPUT_FRAC):
    """One bf16 ulp up or down on the channels of a seeded `frac` of the
    pixels of a float32 (B, 3, H, W) or (B, H, W, 3) batch; the other
    values unchanged (the model rounds them as before)."""
    import ml_dtypes

    rng = np.random.RandomState(seed)
    x = np.asarray(images, np.float32)
    caxis = 1 if x.shape[1] == 3 else 3
    shape = list(x.shape)
    shape[caxis] = 1
    pick = np.broadcast_to(rng.rand(*shape) < frac, x.shape)
    step = np.broadcast_to(rng.choice(np.array([-1, 1], np.int32), shape),
                           x.shape)
    bits = x.astype(ml_dtypes.bfloat16).view(np.uint16).astype(np.int32)
    moved = (bits + step).astype(np.uint16).view(ml_dtypes.bfloat16)
    return np.where(pick, moved.astype(np.float32), x)


def _stage_interceptor(caps):
    """A flax method interceptor that records the twin's stage outputs
    (NHWC) in caps while a model.apply traces."""
    def intercept(next_fun, args, kwargs, context):
        name = context.module.name
        call = context.method_name == "__call__"
        if call and name in STAGE_INPUTS:
            caps[STAGE_INPUTS[name]] = args[0]
        out = next_fun(*args, **kwargs)
        if call and name == "backbone":
            caps["layer4"] = out["out"]
        elif call and name in STAGE_OUTPUTS:
            caps[STAGE_OUTPUTS[name]] = out
        return out

    return intercept


def _tta_interceptor(views):
    """A flax method interceptor that records, while the eager TTA forward
    runs, each view's BF16_TTA_STAGES outputs (NHWC) in views, a dict a
    view: the stem (layer1_0's input, which starts a forward) and the
    decoder (cls1's output)."""
    def intercept(next_fun, args, kwargs, context):
        name = context.module.name
        call = context.method_name == "__call__"
        if call and name == "layer1_0":
            views.append({"stem": args[0]})
        out = next_fun(*args, **kwargs)
        if call and name == "cls1":
            views[-1]["decoder"] = out
        return out

    return intercept


@functools.lru_cache(maxsize=None)
def jax_path(name):
    """The JAX package's entry points of the fixture, built once, so that
    the perturbed runs reuse their compiled programs: the bf16 model and
    its Config, make_eval_step, a forward that also returns the twin's
    stage outputs, the step-0 gradient of the train step's loss_fn,
    make_train_step and the recipe's PseudoLabelGenerator."""
    import flax.linen as fnn
    import jax

    from mulactseg_tpu.engine.state import make_optimizer
    from mulactseg_tpu.engine.train import (
        _build_loss_fn,
        get_criterion,
        make_eval_step,
        make_train_step,
    )
    from mulactseg_tpu.plbl.generator import PseudoLabelGenerator

    cfg = jax_config(name)
    model = jax_model(name)

    @functools.partial(jax.jit, static_argnums=2)
    def with_stages(vs, x, train):
        caps = {}
        with fnn.intercept_methods(_stage_interceptor(caps)):
            if train:
                out, mut = model.apply(vs, x, train=True,
                                       mutable=["batch_stats"],
                                       nchw_logits=True)
                return out, mut["batch_stats"], caps
            return model.apply(vs, x, train=False, return_feat=True), caps

    step0 = jax.numpy.zeros((), jax.numpy.int32)

    def step0_grad(c):
        loss_fn = _build_loss_fn(model, c, get_criterion(c))
        return jax.jit(jax.grad(lambda p, s, b, r: loss_fn(p, s, b, r, step0),
                                has_aux=True))

    recipe = cs.bf16_recipe(name)
    # one optimizer: the train state carries it as static data, so a new
    # one would compile the step anew
    return SimpleNamespace(
        cfg=cfg, model=model, eval_step=make_eval_step(model),
        with_stages=with_stages, grad=step0_grad(cfg), tx=make_optimizer(cfg),
        step=make_train_step(model, cfg, donate=False),
        gen=PseudoLabelGenerator(model, jax_config(name, "plbl"),
                                 "cosprop_includeonehot",
                                 use_tta=recipe["tta"]),
        s2_grad=(step0_grad(jax_config(name, "stage2"))
                 if recipe["stage2"] else None))


def jax_outputs(name, variables, inputs, input_seed=None, s2_labels=None):
    """The JAX package's bf16 path on the fixture (the module docstring):
    {key: array or {leaf path: array}}, the keys of
    chip_smoke.bf16_port_outputs, and 'plbl_margin'. input_seed: bump
    every image the model reads with that seed. s2_labels: stage 2's
    training labels, (B, H, W) uint8 (by default this run's
    pseudo-labels)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    from PIL import Image

    from mulactseg_tpu.acquisition import get_selector
    from mulactseg_tpu.active import RegionActiveSet
    from mulactseg_tpu.data.synthetic import SyntheticRegionDataset
    from mulactseg_tpu.engine.state import TrainState
    from mulactseg_tpu.plbl import generator as jax_generator
    from mulactseg_tpu_torch.config import Config as PortConfig
    from mulactseg_tpu_torch.plbl.generator import (
        PseudoLabelGenerator as PortGenerator,
    )

    fns = jax_path(name)
    cfg = fns.cfg
    batches, pool = inputs
    if input_seed is not None:
        batches = [{**b, "images": bump(b["images"], input_seed * 100 + i)}
                   for i, b in enumerate(batches)]
    b0 = batches[0]
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    v = {"params": params, "batch_stats": stats}

    def nhwc(x):
        return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1))

    def nchw(x):
        return np.ascontiguousarray(np.asarray(x, np.float32).transpose(
            0, 3, 1, 2))

    with mock.patch.object(fnn.Dropout, "__call__", lambda self, x, **kw: x):
        logits = nchw(fns.eval_step(params, stats, jnp.asarray(nhwc(
            b0["images"]))))
        (feat, _), caps = fns.with_stages(v, jnp.asarray(nhwc(b0["images"])),
                                          False)
        out = cs.bf16_outputs_common(name, logits, nchw(feat),
                                     b0["labels"])

        def stage_outputs(mode, caps):
            return {f"stage_{mode}/{k}": cs.bf16_sample(
                name, f"stage_{mode}/{k}", nchw(a), cs.BF16_STAGE_VALUES)
                for k, a in caps.items()}

        out.update(stage_outputs("eval", caps))
        # the train step's forward: bf16 images, train mode
        bf16 = [nhwc(b["images"]).astype(ml_dtypes.bfloat16)
                for b in batches]
        train_logits, new_stats, caps = fns.with_stages(
            v, jnp.asarray(bf16[0]), True)
        out.update(stage_outputs("train", caps))
        out["train_logits"] = np.ascontiguousarray(
            np.asarray(train_logits).transpose(0, 2, 3, 1).reshape(
                -1, train_logits.shape[1])[cs.bf16_pixels(
                    name, cs.BF16_LOGIT_PIXELS)])
        before = dict(cs.tree_leaves(variables["batch_stats"]))
        out["bn_delta"] = {k: np.asarray(a) - before[k]
                           for k, a in cs.tree_leaves(jax.tree_util.tree_map(
                               np.asarray, new_stats))}

        def step_batch(i):
            b = batches[i]
            return {"images": jnp.asarray(bf16[i]),
                    **{k: jnp.asarray(b[k]) for k in
                       ("target", "target_bits", "spx", "spmask")}}

        grads = fns.grad(params, stats, step_batch(0),
                         jax.random.PRNGKey(0))[0]
        grads = {"params": jax.tree_util.tree_map(np.asarray, grads)}
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats, opt_state=fns.tx.init(params),
                           tx=fns.tx, apply_fn=fns.model.apply)
        losses = []
        for i in range(len(batches)):
            state, aux = fns.step(state, step_batch(i), jax.random.PRNGKey(i))
            if i == 0:
                out["loss0"] = np.array([float(aux[k])
                                         for k in cs.BF16_PARTS])
            losses.append(float(aux["train_loss"]))
        out["losses"] = np.array(losses)
        out.update(cs.bf16_step_outputs(
            name, grads, {"params": variables["params"]},
            {"params": jax.tree_util.tree_map(np.asarray, state.params)}))

        items, suppix = cs.bf16_plbl_items(b0, "nhwc")
        # the TTA forward's outputs, an image each, and its views' stages
        tta_out, views = [], []

        def tta_recorded(*args, **kw):
            tta_out.append(tta_forward(*args, **kw))
            return tta_out[-1]

        tta_forward = jax_generator.tta_feat_forward
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.ExitStack() as stack:
            if fns.gen.use_tta:
                stack.enter_context(mock.patch.object(
                    jax_generator, "tta_feat_forward", tta_recorded))
                stack.enter_context(fnn.intercept_methods(
                    _tta_interceptor(views)))
            fns.gen.generate(params, stats, items, save_dir=tmp,
                             suppix=suppix)
            out["plbl"] = np.stack([np.asarray(Image.open(os.path.join(
                tmp, f"lbl_{b}.png"))) for b in range(len(items))])
        if fns.gen.use_tta:
            # the first image's views, in the forward's order
            for i, caps in enumerate(views[:cs.bf16_tta_views()]):
                for stage in cs.BF16_TTA_STAGES:
                    key = cs.bf16_tta_key(i, stage)
                    out[key] = cs.bf16_sample(name, key, nchw(caps[stage]),
                                              cs.BF16_STAGE_VALUES)
        # each pixel's decision margin, from the generator's own features
        # (bf16 from the direct forward, float32 from TTA's) and float32
        # softmax
        prep = PortGenerator(None, PortConfig(**cs.bf16_config_kw(name)),
                             "cosprop_includeonehot", device="cpu").host_prep
        margins = []
        for b, item in enumerate(items):
            if fns.gen.use_tta:
                f, lg = tta_out[b]
            else:
                f, lg = fns.gen._feat_step(params, stats, jnp.asarray(
                    item["images"]).astype(jnp.bfloat16))
            probs = np.array(jax.nn.softmax(np.asarray(lg, np.float32),
                                            axis=-1))
            margins.append(cs.decision_margins(
                np.array(f, np.float32)[0].reshape(-1, f.shape[-1]),
                probs[0].transpose(2, 0, 1), item["spx"][0],
                prep(item, suppix), cfg.nseg).reshape(item["spx"].shape[1:]))
        # inf (no decision could flip) stays inf in float32
        with np.errstate(over="ignore"):
            out["plbl_margin"] = np.stack(margins).astype(np.float32)

        calls = iter(range(10 ** 6))
        n_batches = -(-cs.BF16_FIXTURES[name]["pool"] // cfg.val_batch_size)

        def predict(imgs):
            imgs = np.asarray(imgs, np.float32)
            if input_seed is not None:
                imgs = bump(imgs, input_seed * 100 + 50
                            + next(calls) % n_batches)
            return fns.eval_step(params, stats, jnp.asarray(imgs))

        out.update(cs.bf16_selection(
            name, get_selector(cfg.active_method, cfg),
            SimpleNamespace(predict_logits=predict), RegionActiveSet, cfg,
            *cs.bf16_pool_sets(SyntheticRegionDataset, name, pool)))
        if fns.s2_grad is not None:
            # stage 2's step 0: CE on the pseudo-labels, bf16 images
            labels = out["plbl"] if s2_labels is None else s2_labels
            g, (aux, _) = fns.s2_grad(
                params, stats, {"images": jnp.asarray(bf16[0]),
                                "labels": jnp.asarray(labels, jnp.int32)},
                jax.random.PRNGKey(0))
            out.update(cs.bf16_stage2_outputs(
                float(aux["train_loss"]),
                {"params": jax.tree_util.tree_map(np.asarray, g)}))
    return out


def scale_params(variables, seed, eps=WEIGHT_EPS):
    """The variables with every parameter scaled by 1 + eps N(0, 1),
    drawn in sorted leaf order; the BN statistics unchanged."""
    import copy

    rng = np.random.RandomState(seed)
    out = copy.deepcopy(variables)
    for _, a in cs.tree_leaves(out["params"]):
        a *= (1.0 + eps * rng.standard_normal(a.shape)).astype(np.float32)
    return out


def tolerance(spread):
    """TOL_FACTOR times the spread, rounded up to two significant digits."""
    t = TOL_FACTOR * spread
    if t <= 0:
        return 0.0
    q = 10.0 ** (math.floor(math.log10(t)) - 1)
    return float(f"{math.ceil(t / q - 1e-9) * q:.2g}")


def tolerances(entry):
    """{output: tolerance} of a fixture's entry: tolerance() of the
    JAX package's spread under one bf16 ulp on 1% of its input pixels."""
    return {k[len("spread_input/"):]: tolerance(float(v))
            for k, v in entry.items() if k.startswith("spread_input/")}


def build(name, log=print):
    """One fixture's entry of the file: the outputs, the digest, the
    spreads, the flip sets and their novel counts."""
    t0 = time.perf_counter()
    variables = cs.bf16_variables(name)
    inputs = cs.bf16_inputs(name)
    base = jax_outputs(name, variables, inputs)
    log(f"{name}: reference in {time.perf_counter() - t0:.1f} s")
    # stage 2 trains on the reference's pseudo-labels in every run
    s2 = base.get("plbl")
    runs = {"input": [], "weights": []}
    for seed in PERTURB_SEEDS:
        runs["weights"].append(jax_outputs(
            name, scale_params(variables, seed), inputs, s2_labels=s2))
        runs["input"].append(jax_outputs(name, variables, inputs,
                                         input_seed=seed, s2_labels=s2))
        log(f"{name}: perturbation seed {seed} done at "
            f"{time.perf_counter() - t0:.1f} s")
    entry = dict(base)
    entry["digest"] = np.array(cs.variables_digest(variables))
    for key, ref in base.items():
        if key in cs.BF16_EXACT:
            flipped = np.stack([r[key] != ref for r in
                                runs["input"] + runs["weights"]])
            entry[f"flips/{key}"] = flipped.any(0)
            # what one more run flips beyond the others: the most
            # positions a run flips that no other run does
            once = flipped.sum(0) == 1
            entry[f"novel/{key}"] = np.int64(max(
                int((f & once).sum()) for f in flipped))
        elif key not in ("eval_confusion", "plbl_margin"):
            for kind, rs in runs.items():
                entry[f"spread_{kind}/{key}"] = np.float64(max(
                    cs.bf16_distance(key, r[key], ref) for r in rs))
    if cs.bf16_recipe(name)["world2"]:
        entry.update(world2_outputs(name))
        log(f"{name}: world 2 done at {time.perf_counter() - t0:.1f} s")
    return entry


# the fixtures the search tried (train_spread), on the JAX package's own
# runs alone: (fixture, batch, hw, nseg, residual scale, fixture seed)
SEARCH = (("twin", 4, 64, 16, 1.0, 1), ("twin", 8, 64, 16, 1.0, 1),
          ("twin", 16, 64, 16, 1.0, 1), ("twin", 4, 128, 16, 1.0, 1),
          ("twin", 8, 128, 16, 1.0, 1), ("twin", 4, 64, 16, 0.1, 1),
          ("twin", 8, 64, 16, 0.1, 1), ("twin", 4, 64, 16, 0.03, 1),
          ("twin", 8, 64, 16, 0.03, 1), ("full", 2, 96, 24, 1.0, 0),
          ("full", 4, 96, 24, 1.0, 0), ("full", 4, 96, 24, 0.1, 0),
          ("full", 4, 97, 24, 0.1, 0), ("voc", 4, 97, 24, 0.1, 2),
          ("voc", 4, 97, 24, 0.1, 3), ("voc", 4, 97, 24, 0.1, 4),
          ("voc", 4, 97, 24, 0.1, 5), ("voc", 4, 96, 24, 0.1, 2),
          ("voc", 4, 97, 24, 0.03, 2), ("voc", 8, 97, 24, 0.1, 2),
          ("voc", 4, 97, 48, 0.1, 2))


def train_spread(name, batch, hw, nseg, residual_scale, seed,
                 seeds=(1, 2, 3)):
    """The JAX package's own bf16 step-0 gradient (the train step's
    loss_fn) on a variant of the fixture (its weights and inputs from
    `seed`), against itself under each perturbation: {"input": ...,
    "weights": ...}, the largest relative L2 distance over `seeds` from
    the unperturbed gradient."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    saved = dict(cs.BF16_FIXTURES[name]), cs.BF16_RESIDUAL_SCALE
    cs.BF16_FIXTURES[name].update(batch=batch, hw=hw, nseg=nseg, seed=seed)
    cs.BF16_RESIDUAL_SCALE = residual_scale
    jax_path.cache_clear()
    try:
        fns = jax_path(name)
        variables = cs.bf16_variables(name)
        b = cs.bf16_inputs(name)[0][0]

        def grad(vs, images):
            batch = {"images": jnp.asarray(images.transpose(0, 2, 3, 1).astype(
                ml_dtypes.bfloat16)), **{k: jnp.asarray(b[k]) for k in
                                         ("target", "target_bits", "spx",
                                          "spmask")}}
            g = fns.grad(jax.tree_util.tree_map(jnp.asarray, vs["params"]),
                         jax.tree_util.tree_map(jnp.asarray,
                                                vs["batch_stats"]),
                         batch, jax.random.PRNGKey(0))[0]
            return np.concatenate([np.asarray(a, np.float64).ravel()
                                   for _, a in cs.tree_leaves(g)])

        with mock.patch.object(fnn.Dropout, "__call__",
                               lambda self, x, **kw: x):
            g0 = grad(variables, b["images"])
            runs = {"input": [grad(variables, bump(b["images"], s * 100))
                              for s in seeds],
                    "weights": [grad(scale_params(variables, s), b["images"])
                                for s in seeds]}
        return {k: max(float(np.linalg.norm(g - g0) / np.linalg.norm(g0))
                       for g in gs) for k, gs in runs.items()}
    finally:
        cs.BF16_FIXTURES[name], cs.BF16_RESIDUAL_SCALE = saved
        jax_path.cache_clear()


def world2_grads(name):
    """The JAX package's own step-0 gradient of the fixture's first batch
    through the train step's loss_fn in bf16, at 1 device and at 2 (the
    batch sharded over a 2-device mesh of host devices, the state
    replicated): {devices: (gradient tree of the params, numpy; the
    loss and its parts)}."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from mulactseg_tpu.parallel.mesh import make_mesh, replicate, shard_batch

    fns = jax_path(name)
    variables = cs.bf16_variables(name)
    b = cs.bf16_inputs(name)[0][0]
    batch = {"images": jnp.asarray(b["images"].transpose(0, 2, 3, 1).astype(
        ml_dtypes.bfloat16)), **{k: jnp.asarray(b[k]) for k in
                                 ("target", "target_bits", "spx", "spmask")}}
    state = jax.tree_util.tree_map(jnp.asarray, variables)
    out = {}
    with mock.patch.object(fnn.Dropout, "__call__", lambda self, x, **kw: x):
        for n in (1, 2):
            st, bt = state, batch
            if n > 1:
                mesh = make_mesh(n)
                st, bt = replicate(state, mesh), shard_batch(batch, mesh)
            g, (aux, _) = fns.grad(st["params"], st["batch_stats"], bt,
                                   jax.random.PRNGKey(0))
            out[n] = (jax.tree_util.tree_map(np.asarray, g),
                      np.array([float(aux[k]) for k in cs.BF16_PARTS]))
    return out


def _flat(tree):
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for _, a in cs.tree_leaves(tree)])


def world2_gradient(name="full"):
    """world2_grads' two gradients against each other: the cosine and the
    relative L2 distance, and each loss."""
    grads = world2_grads(name)
    (g1, l1), (g2, l2) = grads[1], grads[2]
    g1, g2 = _flat(g1), _flat(g2)
    return {"fixture": name, "loss_1": float(l1[-1]), "loss_2": float(l2[-1]),
            "cosine": float(g1 @ g2 / np.linalg.norm(g1) / np.linalg.norm(g2)),
            "rel_l2": float(np.linalg.norm(g2 - g1) / np.linalg.norm(g1))}


def world2_outputs(name):
    """The fixture's 'world2/' entries: the 2-device step-0 gradient of
    world2_grads as the reference keeps a gradient (its sample and norms
    per leaf, chip_smoke.bf16_grad_outputs), its loss and parts, and its
    cosine and relative L2 distance to the 1-device gradient."""
    grads = world2_grads(name)
    (g1, _), (g2, loss) = grads[1], grads[2]
    out = {f"world2/{k}": v for k, v in cs.bf16_grad_outputs(
        name, {"params": g2}).items()}
    f1, f2 = _flat(g1), _flat(g2)
    out["world2/loss0"] = loss
    out["world2/cosine"] = np.float64(f1 @ f2 / np.linalg.norm(f1)
                                      / np.linalg.norm(f2))
    out["world2/rel_l2"] = np.float64(np.linalg.norm(f2 - f1)
                                      / np.linalg.norm(f1))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="one file for every fixture (by default each "
                    "fixture's file of chip_smoke.BF16_FILES)")
    ap.add_argument("--fixtures", nargs="+", default=list(cs.BF16_FIXTURES))
    ap.add_argument("--world2", action="store_true",
                    help="print world2_gradient's reading instead")
    ap.add_argument("--search", action="store_true",
                    help="print train_spread over SEARCH's entries of the "
                    "fixtures instead")
    ap.add_argument("--search-seeds", type=int, default=3,
                    help="--search's perturbations of each kind")
    args = ap.parse_args(argv)
    import tests.conftest  # noqa: F401  (the CPU tests' XLA flags)

    if args.search:
        import json

        seeds = tuple(range(1, args.search_seeds + 1))
        for name, batch, hw, nseg, scale, seed in SEARCH:
            if name not in args.fixtures:
                continue
            print(json.dumps({"fixture": name, "batch": batch, "hw": hw,
                              "nseg": nseg, "residual_scale": scale,
                              "seed": seed, "perturbations": len(seeds),
                              **train_spread(name, batch, hw, nseg, scale,
                                             seed, seeds)}), flush=True)
        return

    if args.world2:
        import json

        for name in args.fixtures:
            print(json.dumps(world2_gradient(name)))
        return

    tree = {name: build(name) for name in args.fixtures}
    files = {}
    for name in args.fixtures:
        files.setdefault(args.out or str(cs.BF16_FILES[name]), []).append(
            name)
    for path, names in files.items():
        np.savez_compressed(path, **cs.bf16_flatten({n: tree[n]
                                                     for n in names}))
        print(f"wrote {path} ({', '.join(names)}): "
              f"{os.path.getsize(path)} bytes")
    print("BF16_TOL = {")
    for name, entry in tree.items():
        print(f"    {name!r}: {tolerances(entry)!r},")
    print("}")
    for name, entry in tree.items():
        for k, v in entry.items():
            if k.startswith("spread_") or k in ("world2/cosine",
                                                "world2/rel_l2"):
                print(f"{name} {k}: {float(v):.6g}")
    for name, entry in tree.items():
        for k, v in entry.items():
            if k.startswith("flips/"):
                print(f"{name} {k}: {int(v.sum())} of {v.size} flip, "
                      f"one run {int(entry['novel/' + k[6:]])} alone")


if __name__ == "__main__":
    main()
