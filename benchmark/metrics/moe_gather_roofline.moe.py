"""moe_gather_roofline.moe: over the traced slice's steps, the least time of
the gather kernels' bytes (the dispatch in the forward and in remat's
recompute, and the combine's backward into the slots, each byte once, at
3.35 TB/s) over the device time of every `moe_gather` kernel."""

from benchmark.metrics import _moe_counts


def read(ctx):
    return _moe_counts.roofline(ctx, "moe_gather", _moe_counts.gather_bytes)
