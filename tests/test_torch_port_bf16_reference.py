"""The bf16 reference file against the JAX package, and the port on the
CPU against the file.

tests/data/bf16_reference.npz (tools_dev/bf16_reference.py) holds the JAX
package's dtype=bfloat16 recipe path on chip_smoke.BF16_FIXTURES (the
recipe's model at full width and the twin), with weights and inputs made
from seeds, the JAX package's own spread under its perturbations and the
pixels or regions of each exact output that flip under them. The card,
which has no JAX, is held to it by chip_smoke.py's bf16_parity phase and
tests/test_torch_port_cuda.py::test_bf16_path_holds_the_jax_reference.

Here:
- the weights chip_smoke.bf16_variables rebuilds from seeds have the
  file's digest;
- the twin's stored outputs are what the JAX package computes now from
  the same seeds: exact outputs (maps, selected regions, the confusion
  matrix) bitwise, floats within 1e-6 of each array's largest entry
  (rtol 1e-6 as well); the full-width fixture's the same, under `slow`;
- the tolerances, chip_smoke.BF16_TOL, are the stated rule applied to
  the file's spreads: twice the spread under one bf16 ulp on 1% of the
  input pixels, rounded up to two significant digits, for every float
  output;
- the port on the CPU under CPU bf16 autocast lies within those
  tolerances of the file, and its exact outputs equal the file's outside
  the flip sets, but at no more positions than one perturbed run of the
  reference flips alone (chip_smoke.bf16_compare); the port in float32
  (its CPU path at cfg.dtype bfloat16) is the control: it holds every
  output but the bitwise agreement of the eval stage outputs, and falls
  outside on an eval one, so the check tells a bf16 path from a float32
  one. The twin here, the full-width fixture under `slow`.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from tools_dev import bf16_reference as br

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref():
    # every fixture's entry, from both reference files
    return {name: cs.bf16_reference_of(name) for name in cs.BF16_FIXTURES}


@pytest.mark.parametrize("name", ["full", "twin"])
def test_weights_from_seeds_match_the_digest(ref, name):
    assert cs.variables_digest(cs.bf16_variables(name)) == str(
        ref[name]["digest"])


def test_tolerances_are_twice_the_spread(ref):
    for name, tols in cs.BF16_TOL.items():
        assert tols == br.tolerances(ref[name]), name
        for key, tol in tols.items():
            spread = float(ref[name][f"spread_input/{key}"])
            assert 2 * spread <= tol <= 2.2 * spread, (name, key)


def _assert_same(key, got, want):
    if isinstance(want, dict):
        assert set(got) == set(want), key
        for leaf in want:
            _assert_same(f"{key}::{leaf}", got[leaf], want[leaf])
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, key
    if want.dtype.kind in "biu" or key.split("::")[0] in cs.BF16_EXACT:
        np.testing.assert_array_equal(got, want, err_msg=key)
    else:
        finite = np.abs(want[np.isfinite(want)])  # margins may be inf
        np.testing.assert_allclose(
            got, want, rtol=1e-6,
            atol=1e-6 * float(np.max(finite, initial=0.0)), err_msg=key)


def _regenerates(ref, name):
    out = br.jax_outputs(name, cs.bf16_variables(name), cs.bf16_inputs(name))
    stored = {k: v for k, v in ref[name].items()
              if k != "digest"
              and not k.startswith(("spread_", "flips/", "novel/"))}
    assert set(out) == set(stored)
    for key in stored:
        _assert_same(key, out[key], stored[key])


def test_twin_reference_regenerates_from_the_jax_package(ref):
    _regenerates(ref, "twin")


@pytest.mark.slow
def test_full_reference_regenerates_from_the_jax_package(ref):
    _regenerates(ref, "full")


def _port_holds(ref, name, cpu_autocast):
    inputs = cs.bf16_inputs(name)
    out = cs.bf16_port_outputs(name, cs.bf16_variables(name), inputs, "cpu",
                               cpu_autocast=cpu_autocast)
    rows, bad = cs.bf16_compare(name, ref[name], {"cpu": out},
                                inputs[0][0]["labels"])
    if cpu_autocast:
        assert not bad["cpu"], (bad, rows)
    else:
        assert cs.bf16_control_outside(bad["cpu"]), rows
        assert all(m.split(" ")[1].startswith("stage_eval/")
                   for m in bad["cpu"]), (bad, rows)


@pytest.mark.parametrize("cpu_autocast", [False, True])
def test_twin_port_on_the_cpu_holds_the_reference(ref, cpu_autocast):
    _port_holds(ref, "twin", cpu_autocast)


@pytest.mark.slow
@pytest.mark.parametrize("cpu_autocast", [False, True])
def test_full_port_on_the_cpu_holds_the_reference(ref, cpu_autocast):
    _port_holds(ref, "full", cpu_autocast)
