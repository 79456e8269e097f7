"""mfu.batch: the served images' operations (counted from the compact
shapes) over the window, as a share of the card's bf16 peak."""

from benchmark.metrics import _counts


def read(ctx):
    if not ctx.get("images"):
        return None
    flops = ctx["images"] * _counts.ensemble_flops_per_image(ctx["config"])
    return 100.0 * flops / ctx["window_s"] / _counts.PEAK_BF16_FLOPS
