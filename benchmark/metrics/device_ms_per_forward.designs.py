"""Device-busy milliseconds per stack forward in the traced window of a
design sweep: the union of the card's operations ÷ the forwards traced."""


def read(ctx):
    forwards = ctx.work.get("forwards", 0)
    if ctx.trace is None or not forwards or ctx.trace.busy_s <= 0.0:
        return None
    return 1e3 * ctx.trace.busy_s / forwards
