"""attn_roofline.train: over the traced slice's steps, the least time of
one attention forward and backward a layer a step, over the device time of
the attention kernels (forward, recompute and backward)."""

from benchmark.metrics import _counts


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("traced_steps"):
        return None
    spent = sum(e - s for _, s, e in tr.ops_in(tr.lo, tr.hi, "attention"))
    if spent <= 0:
        return None
    bound = ctx["traced_steps"] * _counts.train_attention_bound_s(ctx["config"], ctx["batch"])
    return 100.0 * bound / spent
