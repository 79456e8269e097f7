"""idle_in_data.batch: percent of the traced slice the device idled while
the batcher thread moved data: forming the batch, copying in, copying out
or delivering (the innermost program span open then)."""

from benchmark.metrics._program_spans import SERVE, idle_share_in


def read(ctx):
    return idle_share_in(ctx, SERVE, ("batcher.form", "engine.copy_in", "engine.copy_out",
                                       "batcher.deliver"))
