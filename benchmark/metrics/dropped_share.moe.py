"""dropped_share.moe: percent of the token-choices the routers dropped past
an expert's capacity over the window (the MoE layers' route counters). It
reads how evenly the cell's seeded routers split the tokens, a property of
the seeded weights: the expert GEMMs compute every slot whatever is
dropped, so it barely moves the rate."""

from benchmark.metrics._moe_counts import kept_share


def read(ctx):
    share = kept_share(ctx)
    return None if share is None else 100.0 * (1.0 - share)
