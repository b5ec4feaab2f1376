"""K1's share of its roofline in the profiled chunk of a batched synthesis cell."""

from portbench import readers


def read(ctx):
    return readers.kernel_roofline(ctx, "K1", "batch_pipeline")
