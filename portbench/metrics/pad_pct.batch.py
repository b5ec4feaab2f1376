"""The share of the frames the profiled chunk's batched decodes computed
that padding to the batch's frame bucket took (the port's `arttts.decode`
counts)."""

from portbench import spans


def read(ctx):
    return spans.pad_pct(ctx, "batch_pipeline")
