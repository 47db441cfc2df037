"""device.idle_share.train: 1 - the device's busy time a step (the union
of the traced stretch's kernel spans) over the unprofiled window's time
a step, in percent."""

from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx)
