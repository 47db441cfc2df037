"""train.step_ms_p95: the 95th percentile of every interval between two
steps' ends on the device (CUDA events after each step of the unprofiled
window)."""

from benchmark import yardstick


def read(ctx):
    ms = ctx.get("step_ms")
    return yardstick.percentile(ms, 95) if ms else None
