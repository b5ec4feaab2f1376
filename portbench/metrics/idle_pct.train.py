"""The device's idle share in the profiled steps of a training cell."""

from portbench import readers


def read(ctx):
    return readers.idle_pct(ctx, "train_steps")
