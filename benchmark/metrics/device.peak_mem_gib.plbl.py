"""device.peak_mem_gib.plbl: max_memory_allocated() over the window, GiB."""

from benchmark import readers


def read(ctx):
    return readers.peak_gib(ctx)
