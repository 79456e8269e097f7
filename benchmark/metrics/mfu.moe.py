"""mfu.moe: three forwards' counted operations an image (the dense layers,
K experts a token and the router in the MoE layers; a recompute under remat
is not counted) for every image of the window's steps, over the window, as
a share of the card's bf16 peak."""

from benchmark.metrics import _counts, _moe_counts


def read(ctx):
    if not ctx.get("steps") or not _moe_counts.is_moe(ctx.get("config")):
        return None
    flops = 3 * ctx["steps"] * ctx["batch"] * _moe_counts.flops_per_image(ctx["config"])
    return 100.0 * flops / ctx["window_s"] / _counts.PEAK_BF16_FLOPS
