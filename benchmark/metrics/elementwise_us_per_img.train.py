"""elementwise_us_per_img.train: device microseconds of the plain ops (every
kernel neither a matrix product, attention nor a copy) in the traced
slice, per training image of its steps."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.ops or not ctx.get("traced_steps"):
        return None
    spent = sum(e - s for _, s, e in tr.ops_in(tr.lo, tr.hi, "other"))
    return 1e6 * spent / (ctx["traced_steps"] * ctx["batch"])
