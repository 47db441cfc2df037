"""model.layernorm_ms_per_step: device ms a step of the LayerNorm kernels,
forward and backward (benchmark/transformer.py LAYER_NORM), over the
traced stretch."""

from benchmark import readers, transformer


def read(ctx):
    return readers.per(ctx, transformer.layer_norm_s(ctx), "prof_steps")
