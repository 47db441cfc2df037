"""The port's evaluation path (utils/metrics.py, engine/evaluate.py and the
model's bfloat16 feature hand-off) against the JAX package, on the CPU.

- confusion_matrix, MeanIoU (_after_step, _after_step_host,
  _after_step_within_predregion, _after_epoch, _after_epoch_ipr) and
  IoUIgnore: exactly (integer counts, then the same float64 formulas).
- Evaluator.run on the small model twin (weights carried by
  models/convert.py), predignore on and off: identical table strings.
  The logits agree to ~1e-5; the fixture's argmax decisions are all
  further apart than that.
- feat_bf16=True features against flax: both cast to bfloat16 at head
  resolution and upsample in bfloat16, in another order, so 1e-2 relative
  (the bfloat16 tolerance) with an absolute floor of 1e-2 of the largest
  feature.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mulactseg_tpu.config import Config as JaxConfig
from mulactseg_tpu.engine.evaluate import Evaluator as JaxEvaluator
from mulactseg_tpu.utils import metrics as jax_metrics
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.engine.evaluate import Evaluator
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.utils.metrics import (
    IoUIgnore,
    MeanIoU,
    confusion_matrix,
)
from tests.test_torch_port_model import NC, jax_variables, twin_pair

torch.set_num_threads(1)

C, IGN = 6, 255


def _maps(seed, n=3, H=9, W=11):
    """Predictions in [0, C + 2) (C and C + 1 are out of range) or 255,
    targets in [0, C) or 255, plus a few out-of-range targets."""
    rng = np.random.RandomState(seed)
    preds = rng.randint(0, C + 2, (n, H, W)).astype(np.int64)
    preds[rng.rand(n, H, W) < 0.2] = IGN
    targets = rng.randint(0, C, (n, H, W)).astype(np.int64)
    targets[rng.rand(n, H, W) < 0.15] = IGN
    targets[rng.rand(n, H, W) < 0.05] = C + 3
    targets[:, 0, 0] = 2  # class C - 1 is never seen in GT
    targets[targets == C - 1] = 0
    return preds, targets


def test_confusion_matrix_matches_jax():
    preds, targets = _maps(0)
    got = confusion_matrix(torch.from_numpy(preds), torch.from_numpy(targets),
                           num_classes=C, ignore_label=IGN)
    want = jax_metrics.confusion_matrix(jnp.asarray(preds),
                                        jnp.asarray(targets), num_classes=C,
                                        ignore_label=IGN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > 0


@pytest.mark.parametrize("mode", ["step", "host", "predregion"])
def test_mean_iou_matches_jax(mode):
    port, ref = MeanIoU(C, IGN), jax_metrics.MeanIoU(C, IGN)
    for seed in (1, 2):
        preds, targets = _maps(seed)
        if mode == "host":
            port._after_step_host(preds.clip(0, 254).astype(np.uint8),
                                  targets)
            ref._after_step_host(preds.clip(0, 254).astype(np.uint8),
                                 targets)
            continue
        d_port = {"outputs": torch.from_numpy(preds),
                  "targets": torch.from_numpy(targets)}
        d_ref = {"outputs": jnp.asarray(preds), "targets": jnp.asarray(targets)}
        if mode == "step":
            port._after_step(d_port)
            ref._after_step(d_ref)
        else:
            port._after_step_within_predregion(d_port)
            ref._after_step_within_predregion(d_ref)
    assert port._after_epoch() == ref._after_epoch()
    assert port._after_epoch([1, 3]) == ref._after_epoch([1, 3])
    assert port._after_epoch_ipr() == ref._after_epoch_ipr()
    assert port._after_epoch()[C - 1] == 100.0  # never seen in GT


def test_iou_ignore_matches_jax():
    port, ref = IoUIgnore(C, IGN), jax_metrics.IoUIgnore(C, IGN)
    for seed in (3, 4):
        preds, targets = _maps(seed)
        port._after_step({"outputs": torch.from_numpy(preds),
                          "targets": torch.from_numpy(targets)})
        ref._after_step({"outputs": jnp.asarray(preds),
                         "targets": jnp.asarray(targets)})
    assert (port.seen, port.positive, port.correct) == \
        (ref.seen, ref.positive, ref.correct)
    assert port._after_epoch() == ref._after_epoch()
    assert IoUIgnore(C, IGN)._after_epoch() == 100.0


def _eval_batches(seed, n=2, B=2, H=40, W=36):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        images = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
        labels = rng.randint(0, NC - 1, (B, H, W)).astype(np.int32)
        labels[rng.rand(B, H, W) < 0.1] = IGN
        out.append((images, labels))
    return out


@pytest.mark.parametrize("predignore", [True, False])
def test_evaluator_matches_jax(predignore):
    port, ref = twin_pair(separable=False)
    v = jax_variables(ref, 9)
    convert.load_variables(port, v)
    data = _eval_batches(10)
    kw = dict(num_classes=NC - 1, dtype="float32",
              method="active_joint_multi_predignore_lossdecomp")
    want = JaxEvaluator(ref, JaxConfig(**kw)).run(
        v["params"], v["batch_stats"],
        [{"images": im, "labels": lb} for im, lb in data],
        predignore=predignore)
    got = Evaluator(port, Config(**kw), device="cpu").run(
        None, [{"images": im.transpose(0, 3, 1, 2).copy(), "labels": lb}
               for im, lb in data], predignore=predignore)
    assert got[1] == want[1]
    assert got[0] == pytest.approx(want[0], abs=1e-9)
    assert len(got[1].split(",")) == NC + (1 if predignore else 0)


def test_evaluator_loads_state_and_refuses_unported_options():
    port, ref = twin_pair(separable=False)
    convert.load_variables(port, jax_variables(ref, 9))
    sd = {k: t.clone() for k, t in port.state_dict().items()}
    cfg = Config(num_classes=NC - 1, dtype="float32",
                 method="active_joint_multi_predignore_lossdecomp")
    data = [{"images": im.transpose(0, 3, 1, 2).copy(), "labels": lb}
            for im, lb in _eval_batches(11, n=1)]
    want = Evaluator(port, cfg, device="cpu").run(None, data)
    with torch.no_grad():
        for p in port.parameters():
            p.add_(1.0)
    assert Evaluator(port, cfg, device="cpu").run(sd, data) == want
    # on several ranks (parallel/mesh.py) each rank counts its own whole
    # batches, so a loader that hands every rank every batch is refused
    from mulactseg_tpu_torch.parallel import mesh

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh, "world", lambda: 2)
        with pytest.raises(ValueError, match="split='batches'"):
            Evaluator(port, cfg, device="cpu").run(None, data)
    # the sliding arm (test_torch_port_sliding.py holds it against JAX)
    # sums the C real classes over the crop grid, so it takes no predignore
    slide = Evaluator(port, Config(num_classes=NC - 1, sliding_eval=True,
                                   slide_crop=24), device="cpu")
    assert slide.sliding.crop == 24 and slide.sliding.num_classes == NC - 1
    miou, table = slide.run(None, data, predignore=True)
    assert np.isfinite(miou) and len(table.split(",")) == NC


def test_feat_bf16_matches_flax():
    port, ref = twin_pair(separable=True)
    v = jax_variables(ref, 12)
    convert.load_variables(port, v)
    port.eval()
    x = np.random.RandomState(13).randn(1, 65, 65, 3).astype(np.float32)
    with torch.no_grad():
        feat, logits = port(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                            return_feat=True, feat_bf16=True)
        feat32, logits32 = port(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                                return_feat=True)
    feat_j, logits_j = ref.apply(v, jnp.asarray(x), train=False,
                                 return_feat=True, feat_bf16=True)
    assert feat.dtype == torch.bfloat16 and feat_j.dtype == jnp.bfloat16
    got = feat.float().numpy().transpose(0, 2, 3, 1)
    want = np.asarray(feat_j, np.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * scale)
    # only the features change: the logits stay float32 and identical
    assert torch.equal(logits, logits32)
    np.testing.assert_allclose(feat.float().numpy(), feat32.numpy(),
                               rtol=1e-2, atol=1e-2 * scale)
