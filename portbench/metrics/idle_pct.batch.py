"""The device's idle share in the profiled chunk of a batched synthesis cell."""

from portbench import readers


def read(ctx):
    return readers.idle_pct(ctx, "batch_pipeline")
