"""How far the float32 group term strays from float64, in the port and in
the JAX package, over many seeds (CPU only).

For each seed, the inputs of test_torch_port_criteria.py's float64 test
(2 images of 32x24, 7 channels, nseg 16, region_batch's targets) with
N(0, scale^2) logits go through the port's group_multi_label_ce and the
JAX one in float32, and through chip_smoke.group_term_float64. Outside
near-ties (chip_smoke.near_tie_pixels) it reports each side's largest
gradient error in float32 rounding units of the entry's operands (the
float64 run's `unit`; the tests bound it at 8) and as a share of the
largest gradient entry, and the largest loss error in units of 2^-24.

Usage: JAX_PLATFORMS=cpu python tools_dev/group_term_float32_spread.py
           [--seeds 40] [--scales 0.2 1.0]
Prints one JSON line per (scale, only_multi).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import group_term_float64, near_tie_pixels  # noqa: E402
from mulactseg_tpu.losses.partial import (  # noqa: E402
    group_multi_label_ce as jax_gm,
)
from mulactseg_tpu_torch.losses.partial import (  # noqa: E402
    group_multi_label_ce,
)
from tests.test_torch_port_criteria import (  # noqa: E402
    B, CT, H, NSEG, W, region_batch, softmax_planes, valid_ids,
)

ARGS = ("target", "spx", "spmask")


def spread(seed, scale, only_multi):
    rng = np.random.RandomState(seed)
    batch = region_batch(rng)
    logits = (rng.randn(B, CT, H, W) * scale).astype(np.float32)
    kw = dict(nseg=NSEG, temp=0.1, slice_last=False, only_multi=only_multi)
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss = group_multi_label_ce(lt, *(torch.from_numpy(batch[k])
                                      for k in ARGS), **kw)
    loss.backward()
    jl, jg = jax.jit(jax.value_and_grad(lambda lg: jax_gm(
        lg, *(jnp.asarray(batch[k]) for k in ARGS), **kw)))(
        jnp.asarray(logits.transpose(0, 2, 3, 1)))
    l64, g64, unit = group_term_float64(logits, *(batch[k] for k in ARGS),
                                        NSEG, temp=0.1, only_multi=only_multi)
    ties = near_tie_pixels(softmax_planes(logits), valid_ids(
        batch, only_multi), NSEG).reshape(B, 1, H, W)
    out = {}
    for name, lv, g in (("port", float(loss.detach()), lt.grad.double()),
                        ("jax", float(jl), torch.from_numpy(np.asarray(
                            jg).transpose(0, 3, 1, 2).copy()).double())):
        err = torch.where(ties, 0.0, (g - g64).abs())
        out[name] = (float((err / unit).nan_to_num(0.0).max()),
                     float(err.max() / g64.abs().max()),
                     abs(lv - l64) / 2.0 ** -24)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=40)
    ap.add_argument("--scales", type=float, nargs="+", default=[0.2, 1.0])
    a = ap.parse_args()
    torch.set_num_threads(1)
    for scale in a.scales:
        for only_multi in (False, True):
            runs = [spread(s, scale, only_multi) for s in range(a.seeds)]
            line = {"scale": scale, "only_multi": only_multi,
                    "seeds": a.seeds}
            for name in ("port", "jax"):
                units, share, loss = zip(*(r[name] for r in runs))
                line[name] = {"max_units": max(units),
                              "max_share_of_largest": max(share),
                              "max_loss_err_units": max(loss)}
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
