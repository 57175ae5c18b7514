"""The share of the traced window in which the card is idle while the
scheduler is inside ``serve.coalesce`` (its wait for straggler rows), in %."""

from harness import spans


def read(ctx):
    found = spans.in_window(ctx.trace, {"serve.coalesce", "serve.dispatch"})
    if found is None or not any(s.name == "serve.dispatch" for s in found[0]):
        return None
    kept, win = found
    under = spans.idle_under(ctx.trace, [s for s in kept if s.name == "serve.coalesce"], win)
    return 100.0 * under / (ctx.trace.window_s * 1e6)
