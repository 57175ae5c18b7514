"""The median queue wait of the traced window's requests, s: each request's
``serve.queue`` span, from its submit to the start of the enqueue of the
dispatch that carries its last row (the program's own span)."""

from harness import spans


def read(ctx):
    found = spans.in_window(ctx.trace, {"serve.queue"})
    if found is None:
        return None
    return spans.median([(s.end_ns - s.start_ns) / 1e9 for s in found[0]])
