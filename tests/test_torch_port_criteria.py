"""The port's criteria (engine/train.CRITERIA) against the JAX package's,
at the loss: every criterion this port added, and the unfused lossdecomp
(a batch without target bits), on the same numpy-seeded inputs.

B = 2 images of 32x24, nseg 16, 7 target channels (6 classes + the
undefined one), 60% of superpixels selected, among them empty, one-hot
and multi-hot ones (so pixels with no candidate reach every term,
multi_choice_ent's softmax over -inf rows included). The logits are
N(0, 1), with 7 channels, or 6 for the criteria that slice the undefined
channel off (slice_last); the criteria that read an eval-mode forward
(needs_feat: top1plbl, pwce, wgroup) take logits and features from the
small twin model of test_torch_port_model.py, a train-mode forward and
an eval-mode return_feat forward. The JAX side runs jitted on the CPU,
as its own tests run it (the sort-based segment max).

Each criterion also runs on a padded crop: the last 4 rows and 3
columns carry the superpixel id nseg (as the transforms pad spx),
spmask False and label 255. There jnp.take_along_axis gathers a NaN
target row, and a masked pixel's backward multiplies it by 0: the
gradient is NaN on the padded pixels in both packages for 16 of the 20
cases (ROADMAP.md, open questions for the reference's owners), and the
port must match JAX's losses and where its gradient is finite.

Tolerances: loss and parts within 1e-5 relative (float32 sums in another
order). The logits gradient is finite exactly where JAX's is, and within
1e-5 of its largest entry, except on pixels of a segment where two
pixels' probabilities of one class lie within 1e-6 of each other
(chip_smoke.near_tie_pixels): the two softmaxes are not bitwise equal,
so such a near-tie may pick another argmax pixel and move the group
term's gradient there.

The group term's float32 rounding is measured against a float64 run
(chip_smoke.group_term_float64) in both packages, on N(0, 0.2^2) logits
and on N(0, 1) logits, which saturate the T = 0.1 softmax: outside
near-ties every gradient entry lies within 8 float32 rounding units of
its operands (that function's `unit`), and the loss within
8 * 2^-24 * (1 + loss). Over 40 seeds
(tools_dev/group_term_float32_spread.py) the port reads at most 3.4
units and JAX 2.8; at N(0, 1) that is up to 3.1e-4 of the largest entry,
past the 1e-5 above, the reason the float32-against-float32 checks of
the group term use N(0, 0.2^2) logits (at most 7.6e-7 there).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mulactseg_tpu.config import Config as JaxConfig
from mulactseg_tpu.engine import train as jax_train
from chip_smoke import group_term_float64, near_tie_pixels
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
from mulactseg_tpu_torch.engine.train import CRITERIA
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.models.layers import Dropout
from tests.test_torch_port_model import jax_variables, twin_pair

torch.set_num_threads(1)

B, H, W, NSEG, CT = 2, 32, 24, 16, 7
FEAT = ("active_pwce_multi_predignore",
        "active_joint_multi_predignore_top1plbl",
        "active_joint_multi_predignore_wgroup")
# (case id, method, Config overrides)
CASES = [
    ("joint_predignore", "active_joint_multi_predignore", {}),
    ("joint", "active_joint_multi", {}),
    ("mclossablation2", "active_joint_multi_predignore_mclossablation2", {}),
    ("precise", "active_joint_multi_predignore_precise", {}),
    ("multice_precise", "active_joint_multi_predignore_multice_precise", {}),
    ("multient", "active_joint_multi_predignore_multient", {}),
    ("exclusivece", "active_joint_multi_predignore_exclusivece", {}),
    ("lossdecomp_rc", "active_joint_multi_lossdecomp_rc", {}),
    ("lossdecomp_topone", "active_joint_multi_lossdecomp_topone", {}),
    ("pwce", "active_pwce_multi_predignore", {"simw_temp_schedule": True}),
    ("top1plbl", "active_joint_multi_predignore_top1plbl",
     {"within_filtering": True, "plbl_th": 0.3, "dorampup": True}),
    ("mclossablation", "active_joint_multi_predignore_mclossablation", {}),
    ("lscale", "active_joint_multi_predignore_lscale", {}),
    ("wgroup", "active_joint_multi_predignore_wgroup", {}),
    ("ablation_rc", "active_joint_multi_ablation",
     {"loss_type": "rc_multi_ce"}),
    ("ablation_max", "active_joint_multi_ablation",
     {"loss_type": "max_multi_ce"}),
    ("ablation_rand", "active_joint_multi_ablation",
     {"loss_type": "rand_multi_ce"}),
    ("sequence", "active_joint_multi_predignore_sequence", {}),
    ("logprecision", "active_joint_multi_predignore_logprecision", {}),
    ("lossdecomp_unfused", "active_joint_multi_predignore_lossdecomp", {}),
]
PARAMS = [pytest.param(*c, False, id=c[0]) for c in CASES] + \
    [pytest.param(*c, True, id=c[0] + "-padded") for c in CASES]
SLICED = ("active_joint_multi", "active_joint_multi_ablation")
FINITE_ON_PADDING = ("precise", "pwce", "ablation_max", "ablation_rand")


def region_batch(rng, one_hot_only=False, padded=False):
    """Irregular superpixels; each superpixel's targets empty, one-hot or
    multi-hot (2-3 classes), or one-hot only; labels with 255s (the
    precise criteria's CE and sequence's pseudo labels). padded: the
    last 4 rows and 3 columns are crop padding (id NSEG, spmask False,
    label 255)."""
    spx = np.stack([irregular_superpixels(H, W, NSEG, rng)
                    for _ in range(B)]).astype(np.int32)
    target = np.zeros((B, NSEG, CT), np.float32)
    for b in range(B):
        for s in range(NSEG):
            kind = 1 if one_hot_only else rng.choice(3, p=[0.15, 0.45, 0.4])
            n = (0, 1, rng.randint(2, 4))[kind]
            target[b, s, rng.choice(CT, n, replace=False)] = 1.0
    sel = rng.rand(B, NSEG) < 0.6
    spmask = np.take_along_axis(sel, spx.reshape(B, -1), 1).reshape(B, H, W)
    labels = rng.randint(0, CT, (B, H, W)).astype(np.int32)
    labels[rng.rand(B, H, W) < 0.2] = 255
    if padded:
        for a, v in ((spx, NSEG), (spmask, False), (labels, 255)):
            a[:, H - 4:] = v
            a[:, :, W - 3:] = v
    return {"target": target, "spx": spx, "spmask": spmask,
            "labels": labels}


def valid_ids(batch, only_multi=False):
    """(B, P) superpixel ids of the selected pixels, NSEG elsewhere (of
    the multi-hot superpixels only, with only_multi)."""
    spx = batch["spx"].reshape(B, -1)
    mask = batch["spmask"].reshape(B, -1)
    if only_multi:
        multi = batch["target"].sum(-1) > 1
        mask = mask & np.take_along_axis(multi, np.minimum(spx, NSEG - 1), 1)
    return np.where(mask, spx, NSEG)


def softmax_planes(logits, temp=0.1):
    """(B, C, H, W) float32 numpy -> the float32 softmax, (B, C, P)."""
    x = torch.from_numpy(logits)
    return torch.softmax(x.reshape(*x.shape[:2], -1) / temp, dim=1)


def configs(method, over):
    kw = dict(num_classes=CT - 1, nseg=NSEG, method=method, coeff=16.0,
              coeff_mc=8.0, coeff_gm=1.0, entcoeff=0.5, finetune_itrs=10,
              dtype="float32", loader="synthetic")
    kw.update(over)
    return Config(**kw), JaxConfig(**kw)


def twin_forwards(seed, images):
    """The twin's train-mode logits (dropout off) and its eval-mode
    (feat, logits), NCHW numpy."""
    port, ref = twin_pair(separable=True)
    convert.load_variables(port, jax_variables(ref, seed))
    for m in port.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    x = torch.from_numpy(images)
    with torch.no_grad():
        port.eval()
        feat, plbl = port(x, return_feat=True)
        port.train()
        logits = port(x)
    return logits.numpy(), feat.numpy(), plbl.numpy()


@pytest.mark.parametrize("case,method,over,padded", PARAMS)
def test_criterion_matches_jax(case, method, over, padded):
    rng = np.random.RandomState(len(case))
    batch = region_batch(rng, one_hot_only=case == "ablation_rand",
                         padded=padded)
    cfg, jcfg = configs(method, over)
    C = CT - 1 if method in SLICED else CT
    extra_np = None
    if method in FEAT:
        images = rng.randn(B, 3, H, W).astype(np.float32)
        logits, feat, plbl = twin_forwards(len(case), images)
        extra_np = {"feat": feat, "plbl_logits": plbl, "frac": 0.25}
    else:
        logits = rng.randn(B, C, H, W).astype(np.float32)
    assert logits.shape[1] == C

    crit = CRITERIA[method](cfg)
    lt = torch.from_numpy(logits).requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if extra_np is not None:
        extra = {"feat": torch.from_numpy(extra_np["feat"]),
                 "plbl_logits": torch.from_numpy(extra_np["plbl_logits"]),
                 "frac": extra_np["frac"]}
        total, aux = crit(lt, tb, extra)
    elif getattr(crit, "needs_rng", False):
        total, aux = crit(lt, tb, {"generator": torch.Generator()})
    else:
        total, aux = crit(lt, tb)
    total.backward()

    jcrit = jax_train.CRITERIA[method](jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(lg):
        if extra_np is not None:
            jextra = {"feat": jnp.asarray(extra_np["feat"].transpose(
                0, 2, 3, 1)), "plbl_logits": jnp.asarray(
                extra_np["plbl_logits"].transpose(0, 2, 3, 1)),
                "frac": jnp.float32(extra_np["frac"])}
            return jcrit(lg, jb, jextra)
        if getattr(jcrit, "needs_rng", False):
            return jcrit(lg, jb, {"rng": jax.random.PRNGKey(0)})
        return jcrit(lg, jb)

    (jt, jaux), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(logits.transpose(0, 2, 3, 1)))
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(jt), rtol=1e-5)
    assert float(jt) > 0.0

    got = lt.grad.numpy()
    want = np.asarray(jg).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    if padded:  # NaN on the padded pixels unless no term gathers targets
        assert fin.all() == (case in FINITE_ON_PADDING)
    bad = fin & (np.abs(got - want) > 1e-5 * np.abs(want[fin]).max())
    if bad.any():
        ties = near_tie_pixels(softmax_planes(logits), valid_ids(batch),
                               NSEG).numpy()
        bad_pix = bad.any(axis=1).reshape(B, -1)
        assert not (bad_pix & ~ties).any(), (
            f"{int(bad.sum())} gradient entries differ outside near-ties")


def test_slice_last_refuses_mismatched_channels():
    """slice_last=True with C + 1 logits (or False with C) raises, in both
    packages (partial.py:40-43)."""
    from mulactseg_tpu.losses.partial import multi_choice_ce as jax_mc
    from mulactseg_tpu_torch.losses.partial import multi_choice_ce

    batch = region_batch(np.random.RandomState(0))
    logits = np.zeros((B, CT, H, W), np.float32)
    with pytest.raises(ValueError, match="slice_last=True"):
        multi_choice_ce(torch.from_numpy(logits),
                        *(torch.from_numpy(batch[k]) for k in
                          ("target", "spx", "spmask")))
    with pytest.raises(ValueError, match="slice_last=True"):
        jax_mc(jnp.asarray(logits.transpose(0, 2, 3, 1)),
               *(jnp.asarray(batch[k]) for k in ("target", "spx", "spmask")))
    with pytest.raises(ValueError, match="slice_last=False"):
        multi_choice_ce(torch.from_numpy(logits[:, :-1]),
                        *(torch.from_numpy(batch[k]) for k in
                          ("target", "spx", "spmask")), slice_last=False)


@pytest.mark.parametrize("scale", [0.2, 1.0])
@pytest.mark.parametrize("only_multi", [False, True])
def test_group_term_float32_against_float64(scale, only_multi):
    """The group term in float32, the port's and JAX's, against a float64
    run of it on N(0, scale^2) logits: outside near-ties each gradient
    entry within 8 float32 rounding units of its operands, the loss
    within 8 * 2^-24 * (1 + loss); see the module docstring."""
    from mulactseg_tpu.losses.partial import group_multi_label_ce as jax_gm
    from mulactseg_tpu_torch.losses.partial import group_multi_label_ce

    rng = np.random.RandomState(3)
    batch = region_batch(rng)
    logits = (rng.randn(B, CT, H, W) * scale).astype(np.float32)
    args = ("target", "spx", "spmask")
    kw = dict(nseg=NSEG, temp=0.1, slice_last=False, only_multi=only_multi)
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss = group_multi_label_ce(lt, *(torch.from_numpy(batch[k])
                                      for k in args), **kw)
    loss.backward()
    jl, jg = jax.jit(jax.value_and_grad(lambda lg: jax_gm(
        lg, *(jnp.asarray(batch[k]) for k in args), **kw)))(
        jnp.asarray(logits.transpose(0, 2, 3, 1)))
    l64, g64, unit = group_term_float64(logits, *(batch[k] for k in args),
                                        NSEG, temp=0.1, only_multi=only_multi)
    ties = near_tie_pixels(softmax_planes(logits), valid_ids(
        batch, only_multi), NSEG).reshape(B, 1, H, W)
    assert l64 > 0 and bool((~ties).any())
    for name, lv, g in (("port", float(loss.detach()), lt.grad.double()),
                        ("jax", float(jl), torch.from_numpy(np.asarray(
                            jg).transpose(0, 3, 1, 2).copy()).double())):
        assert abs(lv - l64) <= 8 * 2.0 ** -24 * (1 + l64), name
        err = torch.where(ties, 0.0, (g - g64).abs())
        assert bool((err <= 8 * unit).all()), (
            name, float((err / unit).nan_to_num(0.0).max()))
