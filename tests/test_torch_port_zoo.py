"""The rest of the model zoo in the port (MobileNetV2, the DeepLabV3 and
DeepLabV2 heads, the auxiliary head) against the flax models, with
weights carried by models/convert.py.

The ResNet names run on the small twin of test_torch_port_model.py
(ResNet layers (2, 2, 2, 2), stage planes 16-128, plain 7x7 stem) under
the name's head; the MobileNet names run at their own width through both
factories (MobileNetV2 is small). Tolerance 1e-4 (rtol and atol), as
test_torch_port_model.py: float32 convolutions summed in another order.
Train mode runs at 4x33x33 with a per-image scale and offset, as
test_torch_port_train.make_batch makes its images: the ASPP pooling
branch's BN normalises one pooled value per image. MobileNet in train
mode is held within 3e-4 instead: its 52 train-mode BNs over 3x3 maps
(36 values a channel at the end) amplify float32 rounding, and the JAX
model's own float32 logits stray up to 2.6e-4 (in units of 1 + |logit|)
from a float64 run of the port at every batch (4, 6, 8), size (17-65)
and input scale tried, while the port's float32 logits stay within
1.1e-4 of that float64 run; the test checks the float64 run too.
"""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch

from mulactseg_tpu.models import get_model as jax_get_model
from mulactseg_tpu.models.deeplab import DeepLabHeadV2 as JaxV2
from mulactseg_tpu.models.deeplab import DeepLabHeadV3 as JaxV3
from mulactseg_tpu.models.deeplab import DeepLabV3 as JaxDeepLab
from mulactseg_tpu.models.deeplab import SimpleAuxHead as JaxAux
from mulactseg_tpu.models.resnet import ResNet as JaxResNet
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.models.deeplab import (
    DeepLabHeadV2,
    DeepLabHeadV3,
    DeepLabV3,
    SimpleAuxHead,
)
from mulactseg_tpu_torch.models.factory import get_model
from mulactseg_tpu_torch.models.layers import Dropout
from mulactseg_tpu_torch.models.mobilenet import MobileNetV2
from mulactseg_tpu_torch.models.resnet import ResNet
from tests.test_torch_port_model import _flat, jax_variables

torch.set_num_threads(1)

NC = 7
NEW_NAMES = ("deeplabv3_resnet50", "deeplabv3_resnet101",
             "deeplabv3_mobilenet", "deeplabv3plus_mobilenet",
             "deeplabv2_resnet101", "deeplabv2_mobilenet")


def _twin_resnets():
    return (ResNet(layers=(2, 2, 2, 2), stage_planes=(16, 32, 64, 128)),
            JaxResNet(layers=(2, 2, 2, 2),
                      replace_stride_with_dilation=(False, False, True),
                      stage_planes=(16, 32, 64, 128)))


def zoo_pair(name):
    """(port model, flax model) for one of NEW_NAMES."""
    arch, backbone = name.split("_", 1)
    if backbone == "mobilenet":
        return (get_model(name, NC, 16, separable_conv=True, device="cpu"),
                jax_get_model(name, NC, 16, separable_conv=True))
    port_bb, ref_bb = _twin_resnets()
    if arch == "deeplabv3":
        heads = DeepLabHeadV3(512, NC, (6, 12, 18)), JaxV3(NC, (6, 12, 18))
    else:
        heads = DeepLabHeadV2(512, NC), JaxV2(NC)
    return (DeepLabV3(port_bb, heads[0]),
            JaxDeepLab(backbone=ref_bb, classifier=heads[1]))


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _images(seed, n, size=33):
    """Images with a per-image scale and offset (the module docstring)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(n, size, size, 3) * np.linspace(0.5, 2.0, n)[
        :, None, None, None] + np.linspace(-2.0, 2.0, n)[
        :, None, None, None]).astype(np.float32)


@pytest.mark.parametrize("name", NEW_NAMES)
def test_carry_round_trip_consumes_every_leaf(name):
    port, ref = zoo_pair(name)
    v = jax_variables(ref, 0)
    sd = convert.variables_to_state_dict(v)
    assert set(sd) == set(port.state_dict())  # every leaf, exactly once
    convert.load_variables(port, v)
    back = convert.state_dict_to_variables(port.state_dict())
    a, b = _flat(v), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", NEW_NAMES)
def test_eval_logits_and_feat_match_flax(name):
    port, ref = zoo_pair(name)
    v = jax_variables(ref, 2)
    convert.load_variables(port, v)
    port.eval()
    x = np.random.RandomState(3).randn(1, 33, 33, 3).astype(np.float32)
    with torch.no_grad():
        feat, logits = port(_nchw(x), return_feat=True)
        logits_only = port(_nchw(x))
    feat_j, logits_j = ref.apply(v, jnp.asarray(x), train=False,
                                 return_feat=True)
    assert logits.shape == (1, NC, 33, 33)
    np.testing.assert_allclose(logits.numpy().transpose(0, 2, 3, 1),
                               np.asarray(logits_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(feat.numpy().transpose(0, 2, 3, 1),
                               np.asarray(feat_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(logits_only.numpy(), logits.numpy())


@pytest.mark.parametrize("name", NEW_NAMES)
def test_train_mode_logits_and_bn_stats_match_flax(name, monkeypatch):
    port, ref = zoo_pair(name)
    v = jax_variables(ref, 4)
    convert.load_variables(port, v)
    # dropout noise is framework-specific: off on both sides
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, **kw: x)
    for m in port.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    port64 = copy.deepcopy(port).double().train()
    port.train()
    x = _images(5, 4)
    logits = port(_nchw(x)).detach()
    logits_j, mut = ref.apply(v, jnp.asarray(x), train=True,
                              mutable=["batch_stats"], nchw_logits=True)
    tol = 3e-4 if name.endswith("mobilenet") else 1e-4
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               rtol=tol, atol=tol)
    logits64 = port64(_nchw(x).double()).detach().numpy()
    np.testing.assert_allclose(np.asarray(logits_j), logits64, rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(logits.numpy(), logits64, rtol=2e-4,
                               atol=2e-4)
    got = _flat(convert.state_dict_to_variables(port.state_dict())[
        "batch_stats"])
    want = _flat(mut["batch_stats"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_aux_head_through_return_aux_matches_flax():
    """SimpleAuxHead on the low-level features of the ResNet twin (64
    channels), upsampled to the input: (logits, aux) within 1e-4; a model
    without one refuses return_aux."""
    port_bb, ref_bb = _twin_resnets()
    port = DeepLabV3(port_bb, DeepLabHeadV2(512, NC), SimpleAuxHead(64, 5))
    ref = JaxDeepLab(backbone=ref_bb, classifier=JaxV2(NC),
                     aux_classifier=JaxAux(5))
    v = ref.init(jax.random.PRNGKey(6), jnp.zeros((1, 33, 33, 3)),
                 train=False, return_aux=True)
    v = {"params": dict(v["params"]), "batch_stats": dict(v["batch_stats"])}
    assert set(convert.variables_to_state_dict(v)) == set(port.state_dict())
    assert "aux_classifier.classifier.weight" in port.state_dict()
    convert.load_variables(port, v)
    port.eval()
    x = np.random.RandomState(7).randn(2, 33, 33, 3).astype(np.float32)
    with torch.no_grad():
        logits, aux = port(_nchw(x), return_aux=True)
    logits_j, aux_j = ref.apply(v, jnp.asarray(x), train=False,
                                return_aux=True)
    assert aux.shape == (2, 5, 33, 33) and aux.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy().transpose(0, 2, 3, 1),
                               np.asarray(logits_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(aux.numpy().transpose(0, 2, 3, 1),
                               np.asarray(aux_j), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="aux_classifier"):
        zoo_pair("deeplabv2_resnet101")[0](_nchw(x), return_aux=True)


def test_mobilenet_dilation_follows_the_output_stride_rule():
    """OS16 turns the stride of block 13 (the first of the 160-channel
    stage) into dilation: block 13 keeps dilation 1 and blocks 14-16 run
    at 2, as the JAX loop gives them (a block gets the dilation from
    before its own stride is folded in); OS8 folds block 6's stride too
    (blocks 7-13 at 2, 14-16 at 4)."""
    def geometry(os_):
        m = MobileNetV2(os_)
        blocks = [*m.low_level_features[1:], *m.high_level_features]
        return [(b.conv[-3][0].stride, b.conv[-3][0].dilation)
                for b in blocks]

    os16, os8 = geometry(16), geometry(8)
    assert [s for s, _ in os16] == [1, 2, 1, 2, 1, 1, 2, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1]
    assert [d for _, d in os16] == [1] * 14 + [2] * 3
    assert [d for _, d in os8] == [1] * 7 + [2] * 7 + [4] * 3
    x = torch.zeros(1, 3, 64, 64)
    with torch.no_grad():
        feats = MobileNetV2(16).eval()(x)
    assert feats["low_level"].shape == (1, 24, 16, 16)
    assert feats["out"].shape == (1, 320, 4, 4)
