"""mfu.train: three forwards' operations an image (forward, and the
backward's two products a weight; a recompute under remat is not counted)
for every image of the window's steps, over the window, as a share of the
card's bf16 peak."""

from benchmark.metrics import _counts


def read(ctx):
    if not ctx.get("steps"):
        return None
    flops = 3 * ctx["steps"] * ctx["batch"] * _counts.vit_flops_per_image(ctx["config"])
    return 100.0 * flops / ctx["window_s"] / _counts.PEAK_BF16_FLOPS
