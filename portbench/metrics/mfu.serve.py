"""The whole request's share of the chip's peak over a closed-loop serving window."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx, "closed_loop_serve")
