"""bucket_fill.online: rows asked over the rows the engine's buckets pad
them to, over the window's predict calls."""

from benchmark.drivers._serving import padded_rows


def read(ctx):
    calls = ctx.get("calls") or []
    padded = sum(padded_rows(rows, ctx["buckets"]) for _, _, rows in calls)
    if not padded:
        return None
    return 100.0 * sum(rows for _, _, rows in calls) / padded
