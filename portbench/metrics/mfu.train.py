"""The training step's share of the chip's peak, forward and backward, over the window."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx, "train_steps")
