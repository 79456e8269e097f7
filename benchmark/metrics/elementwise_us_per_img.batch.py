"""elementwise_us_per_img.batch: device microseconds of the plain ops (every
kernel neither a matrix product, attention nor a copy) in the traced
slice's whole predict calls, per image asked for."""

from benchmark.metrics._serve_calls import whole_calls


def read(ctx):
    calls = whole_calls(ctx)
    rows = sum(c[2] for c in calls)
    if not rows or not ctx["trace"].ops:
        return None
    tr = ctx["trace"]
    spent = sum(e - s for lo, hi, _ in calls for _, s, e in tr.ops_in(lo, hi, "other"))
    return 1e6 * spent / rows
