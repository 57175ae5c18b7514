"""The median latency of the served window's requests, from each one's due
time to its full reply, over all requests due in the window (a failed one as
infinite)."""

import math

from harness import openloop


def read(ctx):
    lat = ctx.work.get("latencies")
    if not lat:
        return None
    p50 = openloop.percentile(lat, 0.5)
    return p50 if math.isfinite(p50) else None
