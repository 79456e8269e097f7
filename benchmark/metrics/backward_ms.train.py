"""backward_ms.train: mean device time of a training step's backward (the CUDA
event pair of span step.backward) over the traced slice, in ms."""

from benchmark.metrics._program_spans import mean_device_ms


def read(ctx):
    return mean_device_ms(ctx, "step.backward")
