"""Device-busy milliseconds per slab in the traced window of a bulk
embedding: the union of the card's operations ÷ the slabs traced."""


def read(ctx):
    slabs = ctx.work.get("slabs")
    if ctx.trace is None or not slabs or ctx.trace.busy_s <= 0.0:
        return None
    return 1e3 * ctx.trace.busy_s / len(slabs)
