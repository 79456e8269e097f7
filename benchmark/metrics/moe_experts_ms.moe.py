"""moe_experts_ms.moe: device ms a traced step of the kernels the expert
MLPs launch (span moe.experts: the batched GEMMs and GELU over the slot
buffers; forward and remat's recompute), by their device time in the
trace."""

from benchmark.metrics._moe_counts import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, ("moe.experts",))
