"""The whole pipeline's share of the chip's peak over a batched synthesis window."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx, "batch_pipeline")
