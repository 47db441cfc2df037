"""plbl.host_ms_per_image: host ms an image of the program's plbl.fetch and
plbl.save spans."""

from benchmark import readers


def read(ctx):
    return readers.per(ctx, readers.range_s(
        ctx, ("plbl.fetch", "plbl.save"), "host_s"), "prof_images")
