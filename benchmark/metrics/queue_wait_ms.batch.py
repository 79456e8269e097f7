"""queue_wait_ms.batch: mean time a request waited between its arrival at
the batcher and the moment a batch took it (span batcher.queue, one a
request) over the traced slice, in ms."""

from benchmark.metrics._program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "batcher.queue")
