"""launch_ms.batch: mean host time that enqueues one bucket's forward
(span engine.forward: the divisions, the stack and EnsMLP, up to the logits
tensor; no synchronize inside) over the traced slice, in ms."""

from benchmark.metrics._program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "engine.forward")
