"""idle_in_backward.train: percent of the traced slice the device idled while
the host was in a training step's backward (span step.backward innermost)."""

from benchmark.metrics._program_spans import TRAIN, idle_share_in


def read(ctx):
    return idle_share_in(ctx, TRAIN, ("step.backward",))
