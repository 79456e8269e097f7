"""moe_route_ms.moe: device ms a traced step of the kernels the MoE
layers' routing launches (span moe.route: router, softmax, top-k, slots,
auxiliary terms; forward and remat's recompute), by their device time in
the trace, so the device's waits on the host's enqueue stay out."""

from benchmark.metrics._moe_counts import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, ("moe.route",))
