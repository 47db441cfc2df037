"""The port's mixed-superpixel-scale loss (mulactseg_tpu_torch/losses/
mseg.py) and its criterion against the JAX package's, on the same
numpy-seeded inputs.

B = 2 images of 32x24 with two levels (nseg 8 and 16, irregular
superpixels), 7 channels (the predignore model's C + 1), 60% of each
level's superpixels selected, image 1 with its finer level absent (an
all-False spmask row). Logits are N(0, 0.2^2), which leave the softmax
unsaturated (test_torch_port_criteria.py's module docstring).

- The MC term, the group term (T = 1.0, as the criterion pins it) and the
  joint loss: within 1e-5 relative; the logits gradient within 1e-5 of
  its largest entry. On a padded crop (the last 4 rows and 3 columns
  carrying each level's pad id nseg, spmask False) both packages gather a
  NaN target row there, so the gradient is NaN on the padded pixels in
  both and the loss finite (ROADMAP.md, open question 4).
- K5 runs once an image and level, absent levels included.
- Step 0 of active_joint_multi_predignore_mseg through make_train_step
  against the JAX train step (tiny model pair of
  test_torch_port_criteria_step.py): the loss parts within 1e-5
  relative, the parameters after the AdamW step within 1e-4 relative in
  L2 over all leaves.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mulactseg_tpu.engine import train as jax_train
from mulactseg_tpu.losses import mseg as jax_mseg
from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
from mulactseg_tpu_torch.engine.train import make_train_step
from mulactseg_tpu_torch.losses import mseg
from mulactseg_tpu_torch.ops import segment_max
from tests.test_torch_port_criteria import CT, configs
from tests.test_torch_port_criteria_step import (
    _images,
    _jax_state,
    _jbatch,
    _params_tree,
    tiny_pair,
)
from tests.test_torch_port_train import _global_rel

torch.set_num_threads(1)

B, H, W, LEVELS = 2, 32, 24, (8, 16)


def mseg_batch(rng, padded=False):
    """'mseg_spx', 'mseg_spmask' (B, 2, H, W) and 'mseg_target_<i>'
    (B, nseg_i, CT); image 1's finer level absent."""
    spx = np.stack([np.stack([irregular_superpixels(H, W, n, rng)
                              for n in LEVELS]) for _ in range(B)])
    mask = np.stack([np.stack([(rng.rand(n) < 0.6)[spx[b, s]]
                               for s, n in enumerate(LEVELS)])
                     for b in range(B)])
    mask[1, 1] = False
    batch = {"mseg_spx": spx.astype(np.int32), "mseg_spmask": mask}
    for s, n in enumerate(LEVELS):
        t = np.zeros((B, n, CT), np.float32)
        for b in range(B):
            for i in range(n):
                k = rng.randint(1, 4)
                t[b, i, rng.choice(CT, k, replace=False)] = 1.0
        batch[f"mseg_target_{s}"] = t
    if padded:
        for s, n in enumerate(LEVELS):
            for a, v in ((batch["mseg_spx"], n), (batch["mseg_spmask"],
                                                  False)):
                a[:, s, H - 4:] = v
                a[:, s, :, W - 3:] = v
    return batch


def _targets(batch, wrap):
    return [wrap(batch[f"mseg_target_{s}"]) for s in range(len(LEVELS))]


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("term", ["mc", "group", "joint"])
def test_mseg_terms_match_jax(term, padded):
    rng = np.random.RandomState(len(term) + 10 * padded)
    batch = mseg_batch(rng, padded)
    logits = (rng.randn(B, CT, H, W) * 0.2).astype(np.float32)

    def run(pkg, wrap, lg):
        args = (lg, _targets(batch, wrap), wrap(batch["mseg_spx"]),
                wrap(batch["mseg_spmask"]))
        if term == "mc":
            return pkg.mseg_multi_choice_ce(*args, temp=0.1)
        if term == "group":
            return pkg.mseg_group_multi_label_ce(*args, nseg_list=LEVELS,
                                                 temp=1.0)
        return pkg.mseg_joint_loss(*args, nseg_list=LEVELS)[0]

    lt = torch.from_numpy(logits).requires_grad_(True)
    loss = run(mseg, torch.from_numpy, lt)
    loss.backward()
    jl, jg = jax.jit(jax.value_and_grad(
        lambda lg: run(jax_mseg, jnp.asarray, lg)))(
        jnp.asarray(logits.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert np.isfinite(float(jl)) and float(jl) > 0.0
    got = lt.grad.numpy()
    want = np.asarray(jg).transpose(0, 3, 1, 2)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    pad = np.zeros((H, W), bool)
    pad[H - 4:], pad[:, W - 3:] = True, True
    # the MC term's NaN target rows reach the padded pixels only
    assert (~fin).any() == (padded and term != "group")
    assert not (~fin & ~pad).any()
    np.testing.assert_array_less(np.abs(got - want)[fin],
                                 1e-5 * np.abs(want[fin]).max())


def test_k5_runs_once_an_image_and_level(monkeypatch):
    calls = []
    plain = segment_max.segment_max_plain
    monkeypatch.setattr(segment_max, "segment_max_plain",
                        lambda *a: calls.append(a[2]) or plain(*a))
    batch = {k: torch.from_numpy(v)
             for k, v in mseg_batch(np.random.RandomState(1)).items()}
    logits = torch.zeros(B, CT, H, W)
    mseg.mseg_joint_loss(logits, _targets(batch, lambda t: t),
                         batch["mseg_spx"], batch["mseg_spmask"],
                         nseg_list=LEVELS)
    assert calls == [n for n in LEVELS for _ in range(B)]


def test_step0_matches_jax_train_step():
    """The criterion pins the group temperature to 1.0 whatever
    --group_ce_temp says, in both."""
    rng = np.random.RandomState(400)
    batch = mseg_batch(rng)
    batch["images"] = _images(rng)
    method = "active_joint_multi_predignore_mseg"
    cfg, jcfg = configs(method, dict(nseg_list=LEVELS, group_ce_temp=0.1,
                                     train_lr=1e-2))
    port, ref, v = tiny_pair(CT, 4)
    step = make_train_step(port, cfg, device="cpu")
    aux = step(batch)
    jstep = jax_train.make_train_step(ref, jcfg, donate=False)
    state, jaux = jstep(_jax_state(ref, jcfg, v), _jbatch(batch),
                        jax.random.PRNGKey(0))
    assert set(aux) == set(jaux) == {"train_loss", "pos_loss", "group_loss"}
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    err = _global_rel(_params_tree(port), state.params)
    assert err < 1e-4, err
    assert _global_rel(v["params"], state.params) > 20 * err
