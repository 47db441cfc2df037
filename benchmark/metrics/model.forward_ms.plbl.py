"""model.forward_ms.plbl: device ms an image of the kernels launched inside
the program's plbl.forward spans."""

from benchmark import readers


def read(ctx):
    return readers.per(ctx, readers.range_s(ctx, ("plbl.forward",),
                                            "device_s"), "prof_images")
