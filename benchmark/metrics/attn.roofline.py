"""attn.roofline: the attention's bound on the traced steps (the larger of
its bf16 FLOPs over 989 TFLOP/s and the bytes its data needs over 3.35
TB/s, from the port's sdpa.bhnmd and sdpa.bhnpmd counters;
benchmark/transformer.py attn_bound_s) over its kernels' device time, in
percent."""

from benchmark import transformer


def read(ctx):
    t, bound = transformer.attn_s(ctx), transformer.attn_bound_s(ctx)
    if t is None or bound is None:
        return None
    return bound / t * 100.0
