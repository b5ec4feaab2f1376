"""The share of the frames the profiled requests' decodes computed that
padding to the frame bucket took (the port's `arttts.decode` counts)."""

from portbench import spans


def read(ctx):
    return spans.pad_pct(ctx, "closed_loop_serve")
