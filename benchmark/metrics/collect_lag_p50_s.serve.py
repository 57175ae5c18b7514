"""The median wait of the traced window's served dispatches, s, from the end
of the copy of a dispatch's ids to the host on the card to the start of the
scheduler's ``serve.collect`` of it (0 where the scheduler came first):
how long finished designs sat while the scheduler was busy elsewhere."""

from harness import spans


def read(ctx):
    found = spans.in_window(ctx.trace, {"serve.dispatch", "serve.collect"})
    if found is None:
        return None
    return spans.median(spans.collect_lags_s(ctx.trace, *found))
