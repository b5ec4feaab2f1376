"""The device's idle share inside the profiled requests' score
evaluations (the port's `arttts.eval` spans)."""

from portbench import spans


def read(ctx):
    return spans.idle_pct_inside(ctx, "closed_loop_serve", "arttts.eval")
