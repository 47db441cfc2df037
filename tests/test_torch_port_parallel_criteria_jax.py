"""One criterion of each family, and the unfused lossdecomp, at world 2
in the port against the JAX package's step on a 2-device mesh of the
conftest's CPU devices (state replicated, batch sharded, built as
__graft_entry__._grad_invariance builds it): the loss parts within 1e-5
relative, the gradients within 1e-4 relative in L2 over all leaves. The
port's ranks are two gloo processes started by parallel.spawn; the
batch and configurations are those of test_torch_port_parallel_
criteria.py (global batch 4 at 33x33, nseg 12, float32, the recipe's
temperatures).

The model is the tiny pair of test_torch_port_criteria_step.py (a 3x3
conv, BN and ReLU, a biased 1x1 final), not the small twin: the twin's
logits are a bilinear upsampling of a 3x3 map, so a segment's argmax
pixels nearly tie everywhere and move under any change of summation
order. On this batch JAX's own 2-device gradient strays 1.3-6.0% from
its 1-device one there (XLA at the conftest's optimisation level 0; at
T = 1.0 too, 1.6% for the joint criterion), while on the tiny pair's
full-resolution logits the two agree within 1.3e-6, and the port within
1.4e-6 of both (tools_dev/dp_grad_near_ties.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mulactseg_tpu.config import Config as JaxConfig
from mulactseg_tpu.engine.train import _build_loss_fn, get_criterion
from mulactseg_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from mulactseg_tpu_torch.parallel import mesh
from tests import torch_port_parallel_ranks as ranks
from tests.test_torch_port_criteria_step import tiny_pair
from tests.test_torch_port_parallel_criteria import CASES
from tests.test_torch_port_train import _global_rel
from tests.torch_port_parallel_ranks import (
    NC,
    cfg_for,
    cfg_kw,
    for_method,
    full_batch,
)

torch.set_num_threads(1)

FAMILIES = ["joint_predignore", "mclossablation2", "onlinesimwplbl_domc",
            "pwce", "hier_async_weight", "mseg", "sequence", "precise",
            "lossdecomp_unfused"]
METHOD = {c: (m, o) for c, m, o in CASES}


def _tree(grads):
    """The tiny model's gradients by parameter name -> the flax tree."""
    hwio = lambda w: np.transpose(w, (2, 3, 1, 0))
    return {"backbone": {"conv": {"kernel": hwio(grads["backbone.conv."
                                                       "weight"])},
                         "bn": {"scale": grads["backbone.bn.weight"],
                                "bias": grads["backbone.bn.bias"]}},
            "classifier": {"final": {
                "kernel": hwio(grads["classifier.final.weight"]),
                "bias": grads["classifier.final.bias"]}}}


@pytest.fixture(scope="module")
def case():
    port, ref, v = tiny_pair(NC, 3)
    state = {k: t.numpy() for k, t in port.state_dict().items()}
    batch = full_batch(np.random.RandomState(21))
    steps = [(c, cfg_for(*METHOD[c]), [for_method(batch, METHOD[c][0])])
             for c in FAMILIES]
    two = mesh.spawn(ranks.run_all, 2, "gloo", "cpu",
                     [("steps", "criteria_steps", (("tiny", state), steps))],
                     timeout=180)
    return {"ref": ref, "variables": v, "batch": batch, "two": two}


def jax_two_devices(ref, v, method, over, batch):
    """The JAX package's loss parts and gradient of step 0 on a 2-device
    mesh."""
    jcfg = JaxConfig(**cfg_kw(method, over))
    loss_fn = _build_loss_fn(ref, jcfg, get_criterion(jcfg))

    def lg(params, bs, b):
        (_, (aux, _)), g = jax.value_and_grad(loss_fn, has_aux=True)(
            params, bs, b, jax.random.PRNGKey(7), jnp.asarray(0))
        return aux, g

    mesh2 = make_mesh(2)
    state = replicate({"params": v["params"],
                       "batch_stats": v["batch_stats"]}, mesh2)
    jb = shard_batch({k: jnp.asarray(
        x.transpose(0, 2, 3, 1) if k.startswith("images") else x)
        for k, x in for_method(batch, method).items()}, mesh2)
    return jax.jit(lg)(state["params"], state["batch_stats"], jb)


@pytest.mark.parametrize("name", FAMILIES)
def test_world2_step0_matches_jax_two_devices(case, name):
    method, over = METHOD[name]
    aux, g = jax_two_devices(case["ref"], case["variables"], method, over,
                             case["batch"])
    assert float(aux["train_loss"]) > 0.0
    for res in case["two"]:
        got = res["steps"][name]["losses"][0]
        assert set(got) == set(aux)
        for k in aux:
            np.testing.assert_allclose(got[k], float(aux[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name} {k}")
    err = _global_rel(_tree(case["two"][0]["steps"][name]["grads"]), g)
    assert err < 1e-4, err
