"""train.mfu: model FLOPs of a step (forward and backward, counted on the
reference network at the cell's shapes) over the unprofiled step time, as a
share of the card's 989 TFLOP/s bf16 peak."""

from benchmark import yardstick


def read(ctx):
    flops, steps = ctx.get("flops_per_step"), ctx.get("steps")
    if not flops or not steps:
        return None
    step_s = ctx["window_s"] / steps
    return flops / step_s / yardstick.BF16_FLOPS_PER_S * 100.0
