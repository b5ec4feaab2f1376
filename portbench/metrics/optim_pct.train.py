"""The share of the profiled training steps spent in the gradient clip
and the optimizer (the port's `arttts.train.clip` and
`arttts.train.optimizer` spans over its `arttts.train.step` spans)."""

from portbench import spans


def read(ctx):
    return spans.share_of(ctx, "train_steps", ("arttts.train.clip", "arttts.train.optimizer"),
                          "arttts.train.step")
