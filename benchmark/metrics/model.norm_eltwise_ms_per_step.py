"""model.norm_eltwise_ms_per_step: device ms a step of BN, elementwise,
cast, copy and reduction kernels, classified by name (yardstick.KINDS),
over the traced stretch."""

from benchmark import readers


def read(ctx):
    return readers.per(ctx, readers.kind_s(ctx, "norm_eltwise"),
                       "prof_steps")
