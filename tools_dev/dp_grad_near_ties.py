"""How far step 0's parameter gradient moves between the JAX package's
1-device and 2-device programs, and the port's one-rank step, on the
batch of tests/test_torch_port_parallel_criteria.py (CPU only).

For each criterion, on the small model twin (logits upsampled from a 3x3
map) and on the tiny conv/BN pair of test_torch_port_criteria_step.py
(full-resolution logits): the JAX loss and gradient on one device and
on a 2-device mesh (batch sharded), and the port's make_train_step
without a group. Prints the L2 relative deviations between the three,
the measure the parallel tests hold to 1e-4. XLA runs at the test
suite's optimisation level 0 (tests/conftest.py) unless XLA_FLAGS says
otherwise.

Usage: JAX_PLATFORMS=cpu python tools_dev/dp_grad_near_ties.py
           [--models twin tiny] [--temp T] [criterion case ids...]
Prints one JSON line per (model, criterion).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8"
                      " --xla_backend_optimization_level=0")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mulactseg_tpu.config import Config as JaxConfig  # noqa: E402
from mulactseg_tpu.engine.train import (  # noqa: E402
    _build_loss_fn,
    get_criterion,
)
from mulactseg_tpu.parallel.mesh import (  # noqa: E402
    make_mesh,
    replicate,
    shard_batch,
)
from mulactseg_tpu_torch.models import convert  # noqa: E402
from tests import torch_port_parallel_ranks as ranks  # noqa: E402
from tests.test_torch_port_criteria_step import tiny_pair  # noqa: E402
from tests.test_torch_port_model import jax_variables, twin_pair  # noqa
from tests.test_torch_port_parallel_criteria import CASES  # noqa: E402
from tests.test_torch_port_parallel_criteria_jax import (  # noqa: E402
    FAMILIES,
    _tree,
)
from tests.test_torch_port_train import _global_rel  # noqa: E402


def jax_grads(ref, v, method, over, batch, devices):
    jcfg = JaxConfig(**ranks.cfg_kw(method, over))
    loss_fn = _build_loss_fn(ref, jcfg, get_criterion(jcfg))

    def lg(params, bs, b):
        (_, (aux, _)), g = jax.value_and_grad(loss_fn, has_aux=True)(
            params, bs, b, jax.random.PRNGKey(7), jnp.asarray(0))
        return aux, g

    jb = {k: jnp.asarray(x.transpose(0, 2, 3, 1) if k.startswith("images")
                         else x)
          for k, x in ranks.for_method(batch, method).items()}
    state = {"params": v["params"], "batch_stats": v["batch_stats"]}
    if devices > 1:
        mesh = make_mesh(devices)
        state, jb = replicate(state, mesh), shard_batch(jb, mesh)
    return jax.jit(lg)(state["params"], state["batch_stats"], jb)[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cases", nargs="*", default=FAMILIES)
    ap.add_argument("--models", nargs="+", default=["twin", "tiny"])
    ap.add_argument("--temp", type=float, default=None,
                    help="group_ce_temp and multi_ce_temp (the recipe's "
                    "0.1 by default)")
    args = ap.parse_args()
    torch.set_num_threads(1)
    fnn.Dropout.__call__ = lambda self, x, **kw: x  # dropout off, as the tests
    method_of = {c: (m, o) for c, m, o in CASES}
    batch = ranks.full_batch(np.random.RandomState(21))
    for model in args.models:
        if model == "twin":
            ref = twin_pair(separable=True)[1]
            v = jax_variables(ref, 7)
            spec = ("twin", v)
        else:
            port, ref, v = tiny_pair(ranks.NC, 3)
            spec = ("tiny", {k: t.numpy()
                             for k, t in port.state_dict().items()})
        for case in args.cases:
            method, over = method_of[case]
            if args.temp is not None:
                over = dict(over, group_ce_temp=args.temp,
                            multi_ce_temp=args.temp)
            g1, g2 = (jax_grads(ref, v, method, over, batch, n)
                      for n in (1, 2))
            grads = ranks.criteria_steps(spec, [(case, ranks.cfg_for(
                method, over), [ranks.for_method(batch, method)])])[case][
                "grads"]
            gp = (convert.state_dict_to_variables(
                {n: torch.from_numpy(a) for n, a in grads.items()})["params"]
                if model == "twin" else _tree(grads))
            print(json.dumps({
                "model": model, "case": case, "temp": args.temp,
                "jax2_vs_jax1": float(_global_rel(g2, g1)),
                "port_vs_jax1": float(_global_rel(gp, g1)),
                "port_vs_jax2": float(_global_rel(gp, g2))}), flush=True)


if __name__ == "__main__":
    main()
