"""The VOC recipe's bf16 reference file against the JAX package, and the
port on the CPU against the file.

tests/data/bf16_reference_voc.npz (tools_dev/bf16_reference.py
--fixtures voc) holds the JAX package's dtype=bfloat16 path on
chip_smoke.BF16_FIXTURES["voc"]: the VOC recipe's model at full width (21
outputs, no predignore class) at an odd size, as 513 x 513 is, its
criterion (active_joint_multi_lossdecomp), selector
(my_bvsb_predclsbal_pwr, fair counting, or labelling), the 10-view TTA
pseudo-labeller (with the stem and decoder outputs of each view of the
first image), stage 2's step 0 (CE on the file's own pseudo-labels), the
JAX package's own spread under its perturbations and the pixels or
regions of each exact output that flip under them; and under 'world2/'
the step-0 gradient on a 2-device mesh of host devices with its distance
to the 1-device one. The card, which has no JAX, is held to it by
chip_smoke.py's bf16_parity and bf16_world2 phases and
tests/test_torch_port_cuda.py.

Here:
- the weights chip_smoke.bf16_variables rebuilds from seeds have the
  file's digest;
- the tolerances are the stated rule applied to the file's spreads
  (tests/test_torch_port_bf16_reference.py checks every fixture's), and
  the JAX package's own 2-device gradient lies within its input spread
  of the 1-device one;
- the port on the CPU under CPU bf16 autocast lies within those
  tolerances of the file at the eval outputs, the TTA pseudo-labels and
  the views' stages, and stage 2's step 0, and its exact outputs equal
  the file's outside the flip sets but at no more positions than one
  perturbed run of the reference flips alone; the port in float32 (its
  CPU path at cfg.dtype bfloat16) is the control: it falls outside on an
  eval output, so the check tells a bf16 path from a float32 one;
- under `slow`: the file's outputs and its world2/ entries regenerate
  from the JAX package.
"""

import pytest
import torch

import chip_smoke as cs
from test_torch_port_bf16_reference import _assert_same  # beside this file
from tools_dev import bf16_reference as br

torch.set_num_threads(1)

NAME = "voc"


@pytest.fixture(scope="module")
def ref():
    return cs.bf16_reference_of(NAME)


def test_voc_weights_from_seeds_match_the_digest(ref):
    assert cs.variables_digest(cs.bf16_variables(NAME)) == str(ref["digest"])


def test_voc_jax_world2_lies_within_its_input_spread(ref):
    assert float(ref["world2/cosine"]) > 0.0
    assert float(ref["world2/rel_l2"]) <= float(ref["spread_input/grad0"])
    for key in ("grad0", "grad0_norm", "loss0"):
        assert cs.bf16_distance(key, ref[f"world2/{key}"], ref[key]) <= \
            cs.BF16_TOL[NAME][key], key


@pytest.mark.parametrize("cpu_autocast", [False, True])
def test_voc_port_on_the_cpu_holds_the_reference(ref, cpu_autocast):
    inputs = cs.bf16_inputs(NAME)
    out = cs.bf16_port_outputs(NAME, cs.bf16_variables(NAME), inputs, "cpu",
                               cpu_autocast=cpu_autocast,
                               parts=("eval", "plbl", "stage2"),
                               s2_labels=ref["plbl"])
    assert {"eval_pred", "plbl", "s2_loss0", "s2_grad0_norm"} <= set(out)
    assert any(k.startswith("stage_tta/") for k in out)
    rows, bad = cs.bf16_compare(NAME, ref, {"cpu": out},
                                inputs[0][0]["labels"])
    if cpu_autocast:
        assert not bad["cpu"], (bad, rows)
    else:
        assert cs.bf16_control_outside(bad["cpu"]), rows


@pytest.mark.slow
def test_voc_reference_regenerates_from_the_jax_package(ref):
    out = br.jax_outputs(NAME, cs.bf16_variables(NAME), cs.bf16_inputs(NAME))
    stored = {k: v for k, v in ref.items()
              if k != "digest"
              and not k.startswith(("spread_", "flips/", "novel/",
                                    "world2/"))}
    assert set(out) == set(stored)
    for key in stored:
        _assert_same(key, out[key], stored[key])


@pytest.mark.slow
def test_voc_world2_regenerates_from_the_jax_package(ref):
    out = br.world2_outputs(NAME)
    assert set(out) == {k for k in ref if k.startswith("world2/")}
    for key in out:
        _assert_same(key, out[key], ref[key])
