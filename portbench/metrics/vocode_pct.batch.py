"""The window's share spent in the pipeline's vocoding stage (run_sparc_vocoder)."""

from portbench import readers


def read(ctx):
    return readers.host_share(ctx, "batch_pipeline", "vocode_s")
