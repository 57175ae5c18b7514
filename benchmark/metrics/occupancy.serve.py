"""Row occupancy of the served window's Stage-3 dispatches, in %: the rows
that carried a request ÷ (dispatches × rows a dispatch), from the pipeline's
dispatch counters read before the window and after its last reply."""


def read(ctx):
    n = ctx.work.get("dispatches", 0)
    if not n:
        return None
    return 100.0 * ctx.work["rows_live"] / (n * ctx.work["rows"])
