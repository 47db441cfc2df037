"""loss.kernel_ms_per_step: device ms a step of K1-K4 (pixel_ce_fwd,
pixel_ce_bwd, ssm_fwd, ssm_bwd), their launch counters checked against the
traced spans."""

from benchmark import readers

K1_K4 = ("pixel_ce_fwd", "pixel_ce_bwd", "ssm_fwd", "ssm_bwd")


def read(ctx):
    return readers.per(ctx, readers.kernels_s(ctx, K1_K4), "prof_steps")
