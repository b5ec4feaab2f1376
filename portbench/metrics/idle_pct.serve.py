"""The device's idle share in the profiled requests of a closed-loop serving cell."""

from portbench import readers


def read(ctx):
    return readers.idle_pct(ctx, "closed_loop_serve")
