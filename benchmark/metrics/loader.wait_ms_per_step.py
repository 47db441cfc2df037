"""loader.wait_ms_per_step: host ms spent in next(loader) a step, the mean
over every step of the unprofiled window."""


def read(ctx):
    w = ctx.get("loader_wait_s")
    return sum(w) / len(w) * 1e3 if w else None
