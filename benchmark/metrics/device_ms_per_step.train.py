"""Device-busy milliseconds per optimizer step in the traced window of a
training run: the union of the card's operations ÷ the steps traced."""


def read(ctx):
    steps = ctx.work.get("steps", 0)
    if ctx.trace is None or not steps or ctx.trace.busy_s <= 0.0:
        return None
    return 1e3 * ctx.trace.busy_s / steps
