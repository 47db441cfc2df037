"""device.idle_share.plbl: 1 - the device's busy time an image (the union
of the traced stretch's kernel spans) over the unprofiled window's time
an image, in percent."""

from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx)
