"""An open-loop client: requests sent on a schedule fixed in advance,
whatever the server does, each timed from when it was due.

``arrival_offsets`` gives a Poisson process's arrivals for a rate and a
window with the seed ordering a fixed set of gaps (the exponential's
quantiles), so every seed sends the same number of requests over the same
span.  ``OpenLoop.run`` sends each request at its due time from one generator
thread onto a pool of workers and records, per request, when it was due, sent
and answered, and whether it succeeded; a late send (the generator behind its
schedule) delays the request's reply and so counts in its latency.
"""

from __future__ import annotations

import dataclasses
import math
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def arrival_offsets(rng: np.random.Generator, rate: float, seconds: float) -> np.ndarray:
    """Due times in [0, seconds) of round(rate · seconds) requests: the gaps
    are the exponential's quantiles at (i + 0.5) / n, in the seed's order,
    scaled to span the window."""
    n = max(1, int(round(rate * seconds)))
    gaps = np.array([-math.log(1.0 - (i + 0.5) / n) for i in range(n)]) / rate
    gaps = rng.permutation(gaps)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return due * (seconds / gaps.sum())


@dataclasses.dataclass
class Sent:
    due: float          # on time.perf_counter()'s clock
    sent: float = math.nan
    done: float = math.nan
    ok: bool = False
    reply: object = None

    @property
    def latency(self) -> float:
        """From due to reply; a failed request never meets any limit."""
        return self.done - self.due if self.ok else math.inf


def percentile(latencies, q: float) -> float:
    """The q-quantile (0..1) by the nearest rank over all requests, failed
    ones as infinite."""
    xs = sorted(latencies)
    if not xs:
        return math.nan
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


class OpenLoop:
    def __init__(self, send, workers: int = 256):
        """``send(request) -> (ok, reply)`` makes one request, blocking."""
        self.send = send
        self.workers = workers

    def run(self, start: float, schedule, on_send=None) -> list[Sent]:
        """``schedule``: [(offset s, request)], sent at ``start`` + offset;
        ``on_send(now)`` is called on the generator's thread after each send.
        Returns when every request has been answered or has failed."""
        records = [Sent(start + off) for off, _ in schedule]

        def one(rec: Sent, request):
            rec.sent = time.perf_counter()
            try:
                rec.ok, rec.reply = self.send(request)
            except Exception as exc:  # noqa: BLE001 — a failed request is counted, not raised
                rec.ok, rec.reply = False, repr(exc)
            rec.done = time.perf_counter()

        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            futures = []
            for rec, (_, request) in zip(records, schedule):
                wait = rec.due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                futures.append(pool.submit(one, rec, request))
                if on_send is not None:
                    on_send(time.perf_counter())
            for f in futures:
                f.result()
        return records


def lateness(records) -> float:
    """How far behind its schedule the generator sent, at worst (s)."""
    return max((r.sent - r.due for r in records), default=0.0)

