"""The port's model (mulactseg_tpu_torch.models) against the flax model on
the small twin of test_full_model_parity.py (ResNet layers (2, 2, 2, 2),
stem 16, low 12, mid 64), with weights carried by models/convert.py.

Tolerance 1e-4 (rtol and atol), as test_full_model_parity.py: float32
convolutions summed in another order. Train mode runs at 4x33x33: the
JAX FastBatchNorm sums its batch statistics in float32 over every pixel,
so at larger inputs its own rounding grows past the tolerance, and with
only 2 images the ASPP pooling branch's BN normalises 2 values and is
ill-conditioned (both float32 runs then stray ~2e-4 from a float64 run of
the port).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch

from mulactseg_tpu.models import get_model as jax_get_model
from mulactseg_tpu.models.deeplab import DeepLabHeadV3Plus as JaxHead
from mulactseg_tpu.models.deeplab import DeepLabV3 as JaxDeepLab
from mulactseg_tpu.models.resnet import ResNet as JaxResNet
from mulactseg_tpu.models.torch_import import torch_state_dict_to_variables
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.models.deeplab import DeepLabHeadV3Plus, DeepLabV3
from mulactseg_tpu_torch.models.factory import get_model
from mulactseg_tpu_torch.models.layers import Dropout
from mulactseg_tpu_torch.models.resnet import ResNet

torch.set_num_threads(1)

NC = 7


def twin_pair(separable):
    port = DeepLabV3(
        ResNet(layers=(2, 2, 2, 2), deep_stem=True, stem_width=16,
               stage_planes=(16, 32, 64, 128)),
        DeepLabHeadV3Plus(512, 64, NC, (6, 12, 18), variant="wn",
                          separable=separable, low_channels=12,
                          mid_channels=64))
    ref = JaxDeepLab(
        backbone=JaxResNet(layers=(2, 2, 2, 2), deep_stem=True,
                           stem_width=16,
                           replace_stride_with_dilation=(False, False, True),
                           stage_planes=(16, 32, 64, 128)),
        classifier=JaxHead(NC, (6, 12, 18), variant="wn",
                           separable=separable, low_channels=12,
                           mid_channels=64))
    return port, ref


def jax_variables(ref, seed):
    """flax init, then BN statistics and scales moved off their defaults
    so that the carry of every leaf is visible in the outputs."""
    v = ref.init(jax.random.PRNGKey(seed), jnp.zeros((1, 33, 33, 3)),
                 train=False)
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name in ("scale", "var"):
            return (a * rng.uniform(0.8, 1.2, a.shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (a + rng.uniform(-0.1, 0.1, a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(
        perturb, {"params": dict(v["params"]),
                  "batch_stats": dict(v["batch_stats"])})


def _flat(tree, leaf=np.asarray):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("separable", [False, True])
def test_carry_round_trip_consumes_every_leaf(separable):
    port, ref = twin_pair(separable)
    v = jax_variables(ref, 0)
    sd = convert.variables_to_state_dict(v)
    assert set(sd) == set(port.state_dict())  # every leaf, exactly once
    convert.load_variables(port, v)
    back = convert.state_dict_to_variables(port.state_dict())
    a, b = _flat(v), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])

    extra = {"params": {**v["params"], "stray": np.zeros(3, np.float32)},
             "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError):
        convert.variables_to_state_dict(extra)
    missing = {"params": dict(v["params"]), "batch_stats": {}}
    with pytest.raises(RuntimeError):
        convert.load_variables(port, missing)


def test_port_checkpoint_readable_by_jax_importer():
    """Non-separable port names are the reference names that the JAX
    package's torch_import reads."""
    port, ref = twin_pair(False)
    v = jax_variables(ref, 1)
    convert.load_variables(port, v)
    sd = {k: t.numpy() for k, t in port.state_dict().items()}
    got = _flat(torch_state_dict_to_variables(sd, wn_head=True))
    want = _flat(v)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("separable", [False, True])
def test_eval_logits_and_feat_match_flax(separable):
    port, ref = twin_pair(separable)
    v = jax_variables(ref, 2)
    convert.load_variables(port, v)
    port.eval()
    x = np.random.RandomState(3).randn(1, 65, 65, 3).astype(np.float32)
    with torch.no_grad():
        feat, logits = port(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                            return_feat=True)
        logits_only = port(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    feat_j, logits_j = ref.apply(v, jnp.asarray(x), train=False,
                                 return_feat=True)
    np.testing.assert_allclose(logits.numpy().transpose(0, 2, 3, 1),
                               np.asarray(logits_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(feat.numpy().transpose(0, 2, 3, 1),
                               np.asarray(feat_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(logits_only.numpy(), logits.numpy())


@pytest.mark.parametrize("separable", [False, True])
def test_train_mode_logits_and_bn_stats_match_flax(separable, monkeypatch):
    port, ref = twin_pair(separable)
    v = jax_variables(ref, 4)
    convert.load_variables(port, v)
    # dropout noise is framework-specific: off on both sides
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, **kw: x)
    for m in port.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    port.train()
    x = np.random.RandomState(5).randn(4, 33, 33, 3).astype(np.float32)
    logits = port(torch.from_numpy(x.transpose(0, 3, 1, 2))).detach()
    logits_j, mut = ref.apply(v, jnp.asarray(x), train=True,
                              mutable=["batch_stats"], nchw_logits=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               rtol=1e-4, atol=1e-4)
    got = _flat(convert.state_dict_to_variables(port.state_dict())[
        "batch_stats"])
    want = _flat(mut["batch_stats"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_full_width_names_and_shapes_match_flax():
    """The recipe model (deeplabv3pluswn_resnet50deepstem, separable, 20
    outputs, OS16): the port's seeded numpy init has exactly the flax
    model's leaves and shapes (flax traced abstractly, nothing computed)."""
    port = get_model("deeplabv3pluswn_resnet50deepstem", 20, 16,
                     separable_conv=True, device="cpu")
    got = _flat(convert.random_variables(port, 0), lambda a: a.shape)
    ref = jax_get_model("deeplabv3pluswn_resnet50deepstem", 20, 16,
                        separable_conv=True)
    shapes = jax.eval_shape(
        lambda: ref.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         train=False))
    want = _flat({"params": shapes["params"],
                  "batch_stats": shapes["batch_stats"]},
                 lambda s: tuple(s.shape))
    assert got == want


@pytest.mark.parametrize("name", ["deeplabv3_resnet50", "deeplabv2_mobilenet",
                                  "deeplabv3plus_mobilenet"])
def test_unported_models_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model(name, 20, device="cpu")
    with pytest.raises(ValueError):
        get_model("not_a_model", 20, device="cpu")
