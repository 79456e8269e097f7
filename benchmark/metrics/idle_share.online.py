"""The device's idle share of the traced slice: one less the union of its
operations' intervals over the slice's length."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
