"""idle_in_optimizer.train: percent of the traced slice the device idled while
the host was in a training step's optimizer (span step.optimizer innermost)."""

from benchmark.metrics._program_spans import TRAIN, idle_share_in


def read(ctx):
    return idle_share_in(ctx, TRAIN, ("step.optimizer",))
