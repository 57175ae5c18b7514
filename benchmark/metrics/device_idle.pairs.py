"""The share of the traced window of a bulk embedding in which no operation
ran on the card, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0.0 or t.busy_s <= 0.0:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s / t.window_s)
