"""The traced slice's whole predict calls of a serving cell: every device
operation of a call runs inside its host span, since the call ends by
copying its logits to the host."""


def whole_calls(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return []
    return [c for c in ctx["calls"] if tr.lo <= c[0] and c[1] <= tr.hi]
