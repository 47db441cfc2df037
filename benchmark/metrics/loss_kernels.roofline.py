"""loss_kernels.roofline: the sum of K1-K4's bounds on the traced batches
(bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s, whichever is
larger, yardstick.loss_kernel_bounds) over the sum of their device time."""

from benchmark import readers

K1_K4 = ("pixel_ce_fwd", "pixel_ce_bwd", "ssm_fwd", "ssm_bwd")


def read(ctx):
    t = readers.kernels_s(ctx, K1_K4)
    bounds = ctx.get("loss_bounds")
    if t is None or not bounds:
        return None
    return sum(bounds[k] for k in K1_K4) / t * 100.0
