"""attn_roofline.batch: over the traced slice's whole predict calls, the
least time of the attention the calls need (each bucket's padded rows,
every division's layers) over the device time of the attention kernels."""

from benchmark.drivers._serving import padded_rows
from benchmark.metrics import _counts
from benchmark.metrics._serve_calls import whole_calls


def read(ctx):
    calls = whole_calls(ctx)
    tr = ctx.get("trace")
    bound = spent = 0.0
    for lo, hi, rows in calls:
        cap = max(ctx["buckets"])
        for s in range(0, rows, cap):
            bound += _counts.ensemble_attention_bound_s(
                ctx["config"], padded_rows(min(cap, rows - s), ctx["buckets"]))
        spent += sum(e - s for _, s, e in tr.ops_in(lo, hi, "attention"))
    if spent <= 0:
        return None
    return 100.0 * bound / spent
