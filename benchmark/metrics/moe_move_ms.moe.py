"""moe_move_ms.moe: device ms a traced step of the kernels that move the
tokens into and out of the experts (spans moe.dispatch and moe.combine;
forward and remat's recompute), by their device time in the trace."""

from benchmark.metrics._moe_counts import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, ("moe.dispatch", "moe.combine"))
