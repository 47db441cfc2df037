"""k5.roofline.plbl: K5's bound on the traced images (its valid pixels,
yardstick.k5_bound) over its device time, its launches checked against the
spans."""

from benchmark import readers


def read(ctx):
    t = readers.kernels_s(ctx, ("seg_max_fwd",))
    b = ctx.get("k5_bound_s")
    if t is None or not b:
        return None
    return b / t * 100.0
