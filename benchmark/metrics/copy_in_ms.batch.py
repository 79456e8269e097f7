"""copy_in_ms.batch: mean host time of a bucket's copy in (span
engine.copy_in: the pad, the writable copy, the copy to the card,
normalize) over the traced slice, in ms."""

from benchmark.metrics._program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "engine.copy_in")
