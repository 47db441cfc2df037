"""How the port's bf16 bilinear resize differs from the JAX package's at
the ratios an odd input size gives the decoder.

DeepLabV3+'s decoder upsamples the ASPP output (output stride 16) to the
low-level features (stride 4). At an even size that is an integer
factor, where both packages compute the exact two-tap interpolation
(mulactseg_tpu/models/layers.py's _upsample_axis_int, F.interpolate).
At an odd size (97 x 97, VOC's 513 x 513, the TTA views) it is not, and
the JAX package calls jax.image.resize, which casts its weight matrices
to the input's dtype and contracts H and W as two bf16 dots, rounding in
between. That path runs inside the jitted steps, and op by op in the
eager TTA forward of the pseudo-labeller (mulactseg_tpu/engine/tta.py),
where XLA keeps fewer float32 intermediates: the integer path's
bf16 x bf16 product is rounded there too. The port's F.interpolate
(mulactseg_tpu_torch/models/layers.py resize_bilinear) interpolates a
bf16 input with float32 weights and rounds its sum to bf16 once, on the
CPU as in CUDA's kernel (autocast leaves it in its input's dtype on
both). This script prints, per (ASPP map, low-level map) shape of the
views of a square input, the share of the port's values that differ
bitwise from the JAX package's, jitted and eager, once both are bf16
(the JAX package's integer path returns float32, which the next
convolution rounds), and the largest absolute difference, on seeded
N(0, 1) bf16 inputs of 64 channels (one bf16 ulp at 1 is 0.0078).

Run: python tools_dev/bf16_resize_gap.py [--sizes 97 513] (seconds, CPU).
"""

import argparse
import math
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TTA_SCALES = (0.5, 0.75, 1.0, 1.25, 1.5)


def gap(src, dst, seed=0):
    """{"jit": (share of values that differ, largest absolute
    difference), "eager": ...} of the port's bf16 resize of a (1, src,
    src, 64) input to dst against the JAX package's."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    import torch

    from mulactseg_tpu.models.layers import resize_bilinear as jax_resize
    from mulactseg_tpu_torch.models.layers import resize_bilinear

    x = np.random.RandomState(seed).randn(1, src, src, 64).astype(
        ml_dtypes.bfloat16)

    def jax_bf16(v):
        return jax_resize(v, (dst, dst)).astype(jnp.bfloat16)

    # NCHW and contiguous, as the model's activations are
    got = resize_bilinear(torch.from_numpy(x.astype(np.float32)).permute(
        0, 3, 1, 2).contiguous().bfloat16(), (dst, dst)).float().permute(
        0, 2, 3, 1).numpy()
    out = {}
    for mode, fn in (("jit", jax.jit(jax_bf16)), ("eager", jax_bf16)):
        want = np.asarray(fn(jnp.asarray(x))).astype(np.float32)
        out[mode] = (float(np.mean(got != want)),
                     float(np.max(np.abs(got - want))))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[97, 513])
    args = ap.parse_args(argv)
    import tests.conftest  # noqa: F401  (the CPU tests' XLA flags)

    for size in args.sizes:
        for s in TTA_SCALES:
            view = int(s * size)
            aspp, low = math.ceil(view / 16), math.ceil(view / 4)
            kind = "integer" if low % aspp == 0 else "non-integer"
            row = gap(aspp, low)
            print(f"input {size}, view {view}: {aspp} -> {low} ({kind}): "
                  + "; ".join(f"{mode} {share:.4f} of values differ, by at "
                              f"most {most:.4g}"
                              for mode, (share, most) in row.items()))


if __name__ == "__main__":
    main()
