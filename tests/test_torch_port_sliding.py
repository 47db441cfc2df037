"""The port's sliding-window evaluation (mulactseg_tpu_torch/engine/
sliding.py), its Evaluator arm, the plbl type that sums features over the
windows and the active_slide criterion, against the JAX package, on the
CPU.

- _window_grid: exactly, over image sizes below, at and above a crop and
  the recipe's 1024x2048 (8 windows at crop 800, stride 534).
- SlidingEval on the small model twin, logits only and with features, on
  an image smaller than a crop (centre-padded) and on overlapping windows
  (B = 2, windows batched 1, 3 and 8 to a forward): the summed logits
  within 1e-5 of the largest summed logit, the renormalised features
  within 1e-5 (the twins' float32 forwards differ by ~1e-6 a window, and
  the sums add up to four of them).
- Evaluator(sliding_eval=True) against JAX's: the same table string (the
  fixture's argmax decisions are further apart than the sums' error).
- cosprop_includeonehot_slide through PseudoLabelGenerator.generate:
  maps on >= 99% of pixels, tables within 0.5 points, K5 once an image.
- active_slide's step 0 (plain CE) against the JAX train step: within
  1e-5 relative.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mulactseg_tpu.config import Config as JaxConfig
from mulactseg_tpu.engine import sliding as jax_sliding
from mulactseg_tpu.engine import train as jax_train
from mulactseg_tpu.engine.evaluate import Evaluator as JaxEvaluator
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.engine import sliding
from mulactseg_tpu_torch.engine.evaluate import Evaluator
from mulactseg_tpu_torch.engine.sliding import SlidingEval, _window_grid
from mulactseg_tpu_torch.engine.train import make_train_step
from tests.test_torch_port_criteria_step import _images, _jax_state, \
    _jbatch, tiny_pair
from tests.test_torch_port_model import NC
from tests.test_torch_port_plbl import _twin_batches
from tests.test_torch_port_simple_plbl import compare_generate, twin  # noqa

torch.set_num_threads(1)

CROP = 24


def test_window_grid_matches_jax():
    for H, W, crop, rate in ((1024, 2048, 800, 0.6667), (375, 500, 800,
                                                          0.6667),
                             (40, 56, 24, 2 / 3), (24, 24, 24, 2 / 3),
                             (25, 71, 24, 0.5), (7, 9, 24, 2 / 3),
                             (513, 513, 321, 0.6667)):
        got = _window_grid(H, W, crop, rate)
        assert got == jax_sliding._window_grid(H, W, crop, rate)
    assert len(_window_grid(1024, 2048, 800, 0.6667)[2]) == 8


def _normalised(rng, B, H, W):
    return rng.randn(B, H, W, 3).astype(np.float32)


@pytest.mark.parametrize("return_feat", [False, True])
@pytest.mark.parametrize("H,W,max_batch", [(17, 20, 8), (40, 56, 3),
                                           (40, 56, 1), (30, 45, 8)])
def test_sliding_eval_matches_jax(twin, return_feat, H, W, max_batch,
                                  monkeypatch):
    port, ref, v = twin
    monkeypatch.setattr(sliding, "WINDOWS_PER_FORWARD", max_batch)
    images = _normalised(np.random.RandomState(H + W), 2, H, W)
    C = NC - 1
    se = SlidingEval(port, C, crop_size=CROP, stride_rate=2 / 3,
                     return_feat=return_feat, device="cpu")
    got = se(torch.from_numpy(images.transpose(0, 3, 1, 2).copy()))
    want = jax_sliding.SlidingEval(ref, C, crop_size=CROP, stride_rate=2 / 3,
                                   return_feat=return_feat)(
        v["params"], v["batch_stats"], jnp.asarray(images))
    assert se.windows == len(_window_grid(H, W, CROP, 2 / 3)[2])
    if return_feat:
        (gf, gl), (wf, wl) = got, want
        wf = np.asarray(wf).transpose(0, 3, 1, 2)
        assert gf.shape == wf.shape and gf.dtype == torch.float32
        np.testing.assert_allclose(gf.numpy(), wf, atol=1e-5)
        np.testing.assert_allclose(
            torch.linalg.vector_norm(gf, dim=1).numpy(), 1.0, atol=1e-5)
    else:
        gl, wl = got, want
    wl = np.asarray(wl).transpose(0, 3, 1, 2)
    assert gl.shape == wl.shape == (2, NC if return_feat else C, H, W)
    np.testing.assert_allclose(gl.numpy(), wl,
                               atol=1e-5 * np.abs(wl).max())


def test_sliding_evaluator_matches_jax(twin):
    port, ref, v = twin
    rng = np.random.RandomState(5)
    kw = dict(num_classes=NC - 1, dtype="float32", sliding_eval=True,
              slide_crop=CROP, method="active_joint_multi_predignore")
    batches = []
    for _ in range(2):
        labels = rng.randint(0, NC - 1, (2, 40, 56)).astype(np.int32)
        labels[rng.rand(2, 40, 56) < 0.1] = 255
        batches.append((rng.randint(0, 256, (2, 40, 56, 3)).astype(np.uint8),
                        labels))
    from mulactseg_tpu.data.transforms import normalize as jax_normalize

    want = JaxEvaluator(ref, JaxConfig(**kw)).run(
        v["params"], v["batch_stats"],
        [{"images": np.stack([jax_normalize(i) for i in im]),
          "labels": lb} for im, lb in batches])
    ev = Evaluator(port, Config(**kw), device="cpu")
    got = ev.run(None, [{"images": im.transpose(0, 3, 1, 2).copy(),
                         "labels": lb} for im, lb in batches])
    assert got == want
    assert len(got[1].split(",")) == NC  # the C classes, no predignore


def test_slide_plbl_type_matches_jax_end_to_end(twin, tmp_path):
    port, ref, v = twin
    jax_b, port_b, suppix = _twin_batches(3, H=40, W=56)
    k5 = compare_generate("cosprop_includeonehot_slide", tmp_path, port_b,
                          jax_b, suppix, port, ref, v, slide_crop=CROP)
    assert k5 == 3


def test_active_slide_step0_matches_jax():
    rng = np.random.RandomState(9)
    images = _images(rng)
    labels = rng.randint(0, 5, (2, 32, 24)).astype(np.int32)
    labels[rng.rand(2, 32, 24) < 0.1] = 255
    batch = {"images": images, "labels": labels}
    kw = dict(num_classes=5, method="active_slide", dtype="float32",
              sliding_eval=True)
    port, ref, v = tiny_pair(5, 3)
    aux = make_train_step(port, Config(**kw), device="cpu")(batch)
    jcfg = JaxConfig(**kw)
    _, jaux = jax_train.make_train_step(ref, jcfg, donate=False)(
        _jax_state(ref, jcfg, v), _jbatch(batch), jax.random.PRNGKey(0))
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(jaux["train_loss"]) > 0.0
