"""model.attn_ms_per_step: device ms a step of the attention kernels,
forward and backward (benchmark/transformer.py ATTN_FORWARD,
ATTN_BACKWARD), over the traced stretch; nothing unless the forward
kernels number the port's `sdpa` calls."""

from benchmark import readers, transformer


def read(ctx):
    return readers.per(ctx, transformer.attn_s(ctx), "prof_steps")
