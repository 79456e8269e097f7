"""moe_combine_roofline.moe: over the traced slice's steps, the least time
of the combine kernels' bytes (the combine in the forward and in remat's
recompute, the dispatch's backward and the weights' gradient, each byte
once, at 3.35 TB/s) over the device time of every `moe_combine` kernel."""

from benchmark.metrics import _moe_counts


def read(ctx):
    return _moe_counts.roofline(ctx, "moe_combine", _moe_counts.combine_bytes)
