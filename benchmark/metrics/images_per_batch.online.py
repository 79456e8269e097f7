"""images_per_batch.online: images over batches the batcher ran in the
window, from its own counters (MicroBatcher.snapshot)."""


def read(ctx):
    (a, b) = ctx.get("batcher", (None, None))
    if a is None or b["batches"] <= a["batches"]:
        return None
    return (b["images"] - a["images"]) / (b["batches"] - a["batches"])
