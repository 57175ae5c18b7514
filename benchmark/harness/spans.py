"""The program's spans laid over a traced window's device trace.

The program keeps spans under a profiler window (``biom3_tpu_torch.utils.
profiling.spans()``: name, thread, start and end in ns of ``time.time_ns()``,
parent, ids), on the clock the profiler's host and device events carry; the
trace holds them in µs.  A checkout whose program keeps no spans gives none,
and every reader here then finds nothing.

The window: ``DeviceTrace.stop`` synchronises the card and then reads
``window_s``, so the window ends where the last ``cudaDeviceSynchronize`` on
the host ends and began ``window_s`` before.  Idle time is the window less the
union of the card's operations.
"""

from __future__ import annotations

import statistics

# the copy of a served dispatch's ids into pinned host memory (``_to_host``)
PINNED_COPY = "Memcpy DtoH (Device -> Pinned)"


def program_spans() -> list:
    """The program's kept spans, or [] where it keeps none."""
    try:
        from biom3_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return list(read()) if read is not None else []


def window_us(trace) -> tuple[float, float] | None:
    """(open, close) of the traced window on the trace's clock, µs."""
    if trace is None or trace.window_s <= 0.0 or not trace.device_ops:
        return None
    syncs = [e for name, _, e in trace.host_ops if name == "cudaDeviceSynchronize"]
    ends = syncs or [e for _, _, e in trace.device_ops + trace.host_ops]
    close = max(ends)
    return close - trace.window_s * 1e6, close


def us(span) -> tuple[float, float]:
    return span.start_ns / 1e3, span.end_ns / 1e3


def in_window(trace, names) -> tuple[list, tuple[float, float]] | None:
    """(the spans named ``names`` that began in the window, the window), or
    None when the trace or the spans are empty."""
    win = window_us(trace)
    kept = program_spans()
    if win is None or not kept:
        return None
    chosen = [s for s in kept if s.name in names and win[0] <= s.start_ns / 1e3 <= win[1]]
    return chosen, win


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a, b) -> float:
    """The length of the intersection of two unions (``merged``'s)."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(trace, win) -> list[tuple[float, float]]:
    """The window's intervals, µs, in which no operation ran on the card."""
    gaps, at = [], win[0]
    for s, e in merged((s, e) for _, s, e in trace.device_ops):
        if s > at:
            gaps.append((at, min(s, win[1])))
        at = max(at, e)
        if at >= win[1]:
            break
    if at < win[1]:
        gaps.append((at, win[1]))
    return [(s, e) for s, e in gaps if e > s]


def idle_under(trace, spans_, win) -> float:
    """The card's idle µs in the window under the union of ``spans_``."""
    clipped = [(max(s, win[0]), min(e, win[1])) for s, e in map(us, spans_)]
    return overlap(idle(trace, win), merged((s, e) for s, e in clipped if e > s))


def collect_lags_s(trace, spans_, win) -> list[float]:
    """Each served dispatch's wait, s, from the end of its ids' copy to the
    card (``PINNED_COPY``) to the start of its ``serve.collect``, 0 where
    the collect began before the copy had landed (``ready`` false).  A
    ready dispatch's copy is the last pinned copy that ended by the
    collect's start and began after the dispatch's enqueue began; dispatches
    enqueued before the window or collected after it are left out."""
    dispatch = {s.ids.get("did"): s for s in spans_ if s.name == "serve.dispatch"}
    copies = sorted((e, s) for name, s, e in trace.device_ops if name == PINNED_COPY)
    lags = []
    for c in spans_:
        d = dispatch.get(c.ids.get("did"))
        start = c.start_ns / 1e3
        if c.name != "serve.collect" or d is None or start > win[1]:
            continue
        if not c.ids.get("ready"):
            lags.append(0.0)
            continue
        landed = [e for e, s in copies if e <= start and s >= d.start_ns / 1e3]
        if landed:
            lags.append((start - landed[-1]) / 1e6)
    return lags


def median(values) -> float | None:
    return statistics.median(values) if values else None
