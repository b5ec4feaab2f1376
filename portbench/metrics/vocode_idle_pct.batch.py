"""The device's idle share inside the profiled chunk's vocoding stage (the
port's `arttts.pipeline.vocode` span)."""

from portbench import spans


def read(ctx):
    return spans.idle_pct_inside(ctx, "batch_pipeline", "arttts.pipeline.vocode")
