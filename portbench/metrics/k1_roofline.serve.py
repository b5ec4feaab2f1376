"""K1's share of its roofline in the profiled requests of a closed-loop serving cell."""

from portbench import readers


def read(ctx):
    return readers.kernel_roofline(ctx, "K1", "closed_loop_serve")
