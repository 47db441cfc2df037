"""plbl.prop_ms_per_image: device ms an image of the kernels launched inside
the program's plbl.pass1, plbl.threshold and plbl.pass2 spans."""

from benchmark import readers


def read(ctx):
    return readers.per(ctx, readers.range_s(
        ctx, ("plbl.pass1", "plbl.threshold", "plbl.pass2"), "device_s"),
        "prof_images")
