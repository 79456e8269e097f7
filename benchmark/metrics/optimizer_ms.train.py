"""optimizer_ms.train: mean device time of a training step's optimizer (the CUDA
event pair of span step.optimizer) over the traced slice, in ms."""

from benchmark.metrics._program_spans import mean_device_ms


def read(ctx):
    return mean_device_ms(ctx, "step.optimizer")
