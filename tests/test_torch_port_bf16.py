"""The port's bf16 path against the JAX package's dtype="bfloat16" model.

The recipe trains and pseudo-labels in bf16 (`--dtype bfloat16`): the JAX
package builds its conv stack with dtype=jnp.bfloat16 (params float32,
inputs cast to bf16, BN statistics accumulated in float32 from the bf16
activations, the cosine head in float32, logits returned in float32), and
the port runs its float32 model under torch.autocast. These tests run the
port under torch.autocast("cpu", dtype=torch.bfloat16) on the small twin
of tests/test_torch_port_model.py (the tiny shapes of
test_full_model_parity.py), with weights carried by models/convert.py and
inputs made with numpy from a seed, and hold:

- the eval-mode forward: logits and normalised features;
- the step-0 lossdecomp loss and its parts on the train-mode logits;
- the BN running statistics after one train-mode forward.

CPU autocast's op lists are not CUDA's (on the CPU, for example, fewer
ops run in bf16), so these tests check the port's casts against the
reference's (the conv stack in bf16, FastBatchNorm's float32 statistics
of bf16 activations and its bf16 affine, the float32 cosine head), not
the card's exact kernel choices. The engine's CUDA-only autocast switch
(engine/train.py) is left as it is: the tests call the model under CPU
autocast themselves.

Tolerances are bf16's: one bf16 ulp is 2**-8 relative (0.0039 at 1.0),
and bf16 rounding alone moves the reference's own outputs far more than
these bounds (its bf16 against its float32 model, same inputs: eval
logits ~0.007, train-mode logits ~0.13, BN statistics ~5% of a leaf).
- eval logits (cosines in [-1, 1]) and features: atol 1e-2, under three
  bf16 ulps at 1.0 (measured ~0.003);
- train-mode logits: atol 5e-2 (measured 0.014-0.019: batch statistics
  of bf16 activations normalise each layer, which amplifies rounding);
- loss and parts: rtol 1e-2 (measured <= 0.6%);
- BN statistics: each leaf's max abs error within 2e-2 of its largest
  entry (measured <= 0.9%).
Dropout is off on both sides (its noise is framework-specific).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch

from mulactseg_tpu.losses.fused import lossdecomp_fused as jax_lossdecomp
from mulactseg_tpu.models.deeplab import DeepLabHeadV3Plus as JaxHead
from mulactseg_tpu.models.deeplab import DeepLabV3 as JaxDeepLab
from mulactseg_tpu.models.resnet import ResNet as JaxResNet
from mulactseg_tpu_torch.losses.fused import lossdecomp_fused
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.models.layers import Dropout
from tests.test_torch_port_model import NC, _flat, jax_variables, twin_pair
from tests.test_torch_port_train import make_batch

torch.set_num_threads(1)

NSEG = 12
LOSS_KW = dict(nseg=NSEG, coeff=16.0, coeff_mc=8.0, coeff_gm=1.0,
               multi_ce_temp=0.1, group_ce_temp=0.1)


def bf16_pair(separable, seed):
    """The port twin with carried weights and dropout off, and the flax
    twin built with dtype=jnp.bfloat16, as the JAX trainer builds it for
    cfg.dtype == "bfloat16" (engine/rounds.py:52)."""
    port, ref32 = twin_pair(separable)
    ref = JaxDeepLab(
        backbone=JaxResNet(layers=(2, 2, 2, 2), deep_stem=True,
                           stem_width=16,
                           replace_stride_with_dilation=(False, False, True),
                           stage_planes=(16, 32, 64, 128),
                           dtype=jnp.bfloat16),
        classifier=JaxHead(NC, (6, 12, 18), variant="wn",
                           separable=separable, low_channels=12,
                           mid_channels=64, dtype=jnp.bfloat16))
    v = jax_variables(ref32, seed)
    convert.load_variables(port, v)
    for m in port.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return port, ref, v


def _train_forward(separable, monkeypatch):
    """One train-mode forward on both sides: (port logits, JAX logits,
    JAX batch_stats, batch)."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, **kw: x)
    port, ref, v = bf16_pair(separable, 4)
    batch = make_batch(np.random.RandomState(7), 4, 33, 33, NC, NSEG)
    port.train()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        logits = port(torch.from_numpy(batch["images"]))
    # the JAX trainer ships bf16 images (engine/rounds.py:186-199)
    logits_j, mut = ref.apply(
        v, jnp.asarray(batch["images"].transpose(0, 2, 3, 1),
                       jnp.bfloat16),
        train=True, mutable=["batch_stats"], nchw_logits=True)
    return port, logits.detach(), np.asarray(logits_j), mut, batch


@pytest.mark.parametrize("separable", [False, True])
def test_bf16_eval_forward_matches_jax(separable):
    port, ref, v = bf16_pair(separable, 2)
    port.eval()
    x = np.random.RandomState(3).randn(2, 65, 65, 3).astype(np.float32)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        feat, logits = port(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                            return_feat=True)
    feat_j, logits_j = ref.apply(v, jnp.asarray(x, jnp.bfloat16),
                                 train=False, return_feat=True)
    assert logits.dtype == torch.float32 and logits_j.dtype == jnp.float32
    np.testing.assert_allclose(logits.numpy().transpose(0, 2, 3, 1),
                               np.asarray(logits_j), rtol=0, atol=1e-2)
    np.testing.assert_allclose(feat.float().numpy().transpose(0, 2, 3, 1),
                               np.asarray(feat_j, np.float32), rtol=0,
                               atol=1e-2)


@pytest.mark.parametrize("separable", [False, True])
def test_bf16_step0_loss_matches_jax(separable, monkeypatch):
    _, logits, logits_j, _, batch = _train_forward(separable, monkeypatch)
    np.testing.assert_allclose(logits.numpy(), logits_j, rtol=0, atol=5e-2)
    total, aux = lossdecomp_fused(
        logits, torch.from_numpy(batch["target_bits"]),
        torch.from_numpy(batch["target"]), torch.from_numpy(batch["spx"]),
        **LOSS_KW)
    jt, jaux = jax_lossdecomp(
        jnp.asarray(logits_j), jnp.asarray(batch["target_bits"]),
        jnp.asarray(batch["target"]), jnp.asarray(batch["spx"]), nchw=True,
        **LOSS_KW)
    for k in ("ce_loss", "mc_loss", "group_loss", "train_loss"):
        assert float(aux[k]) > 0.0, k
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-2,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(jt), rtol=1e-2)


@pytest.mark.parametrize("separable", [False, True])
def test_bf16_train_bn_stats_match_jax(separable, monkeypatch):
    port, _, _, mut, _ = _train_forward(separable, monkeypatch)
    got = _flat(convert.state_dict_to_variables(port.state_dict())[
        "batch_stats"])
    want = _flat(mut["batch_stats"])
    assert got.keys() == want.keys()
    for k in want:
        err = np.abs(got[k] - want[k]).max()
        assert err <= 2e-2 * np.abs(want[k]).max(), (k, err)
