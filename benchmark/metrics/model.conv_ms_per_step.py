"""model.conv_ms_per_step: device ms a step of convolution and GEMM kernels,
classified by name (yardstick.KINDS), over the traced stretch."""

from benchmark import readers


def read(ctx):
    return readers.per(ctx, readers.kind_s(ctx, "conv"), "prof_steps")
