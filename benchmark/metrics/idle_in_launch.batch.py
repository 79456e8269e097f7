"""idle_in_launch.batch: percent of the traced slice the device idled while
the batcher thread enqueued a bucket's forward (span engine.forward
innermost)."""

from benchmark.metrics._program_spans import SERVE, idle_share_in


def read(ctx):
    return idle_share_in(ctx, SERVE, ("engine.forward",))
