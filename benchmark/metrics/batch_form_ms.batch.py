"""batch_form_ms.batch: mean host time of the batcher's batch formation
(span batcher.form: taking the first request, draining the queue, the
concatenation) over the traced slice, in ms."""

from benchmark.metrics._program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "batcher.form")
