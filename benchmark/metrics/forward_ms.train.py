"""forward_ms.train: mean device time of a training step's forward (the CUDA
event pair of span step.forward) over the traced slice, in ms."""

from benchmark.metrics._program_spans import mean_device_ms


def read(ctx):
    return mean_device_ms(ctx, "step.forward")
