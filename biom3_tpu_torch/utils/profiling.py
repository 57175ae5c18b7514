"""Profiling and device-memory observability.

Port of ``biom3_tpu/utils/profiling.py`` (the reference's pynvml/psutil
probes, ``Stage1_source/helper_funcs.py:11-31``): the card's memory from
the CUDA caching allocator (``torch.cuda.memory_stats``), a
``torch.profiler`` window that writes a Chrome trace, and the process RSS.

The program's spans: ``span(name, **ids)`` marks a phase of the program
(a served request's queue, a dispatch's enqueue, a train step's
optimizer), and ``spans()`` returns the kept ones.  A span records only
while a ``torch.profiler`` window is open somewhere in the process, on any
thread (``tracing()``); otherwise it costs one attribute read and returns
a shared no-op context.  A kept span is ``Span(name, thread, start_ns,
end_ns, parent, ids)`` on ``time.time_ns()``'s clock, the one the
profiler's host and device events carry, so a reader lays the spans of
every thread over the device trace of the window; ``ids`` link the
threads' spans (``rid`` a request, ``did`` a dispatch).  A span also enters
``torch.profiler.record_function(name)``, which puts it into the trace as
a host operation on the window's own thread (the profiler records no
range of a thread that was running before the window opened; the spans
of such threads are in ``spans()`` and in ``profile_trace``'s file).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

# the most spans kept; the oldest go first
MAX_SPANS = 1 << 16

# JAX ``Device.memory_stats`` key → the caching allocator's statistic
_MEMORY_KEYS = {
    "bytes_in_use": "allocated_bytes.all.current",
    "peak_bytes_in_use": "allocated_bytes.all.peak",
    "bytes_reserved": "reserved_bytes.all.current",
    "peak_bytes_reserved": "reserved_bytes.all.peak",
}


def device_memory_stats(device=None) -> dict:
    """One card's memory in MiB under the JAX package's keys
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_reserved``,
    ``peak_bytes_reserved``, ``bytes_limit``); empty without a card."""
    if not torch.cuda.is_available():
        return {}
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    stats = torch.cuda.memory_stats(device)
    out = {k: stats.get(v, 0) / 1024**2 for k, v in _MEMORY_KEYS.items()}
    out["bytes_limit"] = torch.cuda.get_device_properties(device).total_memory / 1024**2
    return out


def host_memory_mb() -> float:
    """Process RSS in MB (the reference's psutil probe)."""
    try:
        import psutil

        return psutil.Process(os.getpid()).memory_info().rss / 1024**2
    except ImportError:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS"):
                        return float(line.split()[1]) / 1024
        except OSError:
            pass
        return 0.0



# -- spans -------------------------------------------------------------------


class Span(NamedTuple):
    name: str
    thread: str           # the name of the thread that ended it
    start_ns: int         # time.time_ns()
    end_ns: int
    parent: str | None    # the enclosing span's name on the same thread
    ids: dict             # rid, did, counts


_kept: collections.deque = collections.deque(maxlen=MAX_SPANS)
_kept_lock = threading.Lock()
_open = threading.local()     # .stack: this thread's open spans


def tracing() -> bool:
    """Whether a ``torch.profiler`` window is open in this process (the
    module flag every thread sees; the profiler's own check is per
    thread)."""
    return _autograd_profiler._is_profiler_enabled


def stamp() -> int | None:
    """``time.time_ns()`` while a window is open, else None: the start of a
    span that ends elsewhere (``record``)."""
    return time.time_ns() if tracing() else None


def _keep(span: Span) -> None:
    with _kept_lock:
        _kept.append(span)


def record(name: str, start_ns: int | None, end_ns: int | None = None, **ids) -> None:
    """Keep a span that began at ``start_ns`` (``stamp()``'s, None when no
    window was open then: nothing is kept) and ends now or at ``end_ns``;
    for a phase that starts on one thread and ends on another."""
    if start_ns is None:
        return
    end_ns = time.time_ns() if end_ns is None else end_ns
    _keep(Span(name, threading.current_thread().name, start_ns, end_ns, None, ids))


def spans() -> list[Span]:
    """The kept spans, oldest first."""
    with _kept_lock:
        return list(_kept)


class _Off:
    """The shared context of a span while no window is open."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **ids) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "ids", "_parent", "_range", "_start")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids

    def note(self, **ids) -> None:
        """Add ids known only inside the span (counts at its end)."""
        self.ids.update(ids)

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self._parent = stack[-1].name if stack else None
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._range.__exit__(*exc)
        _open.stack.pop()
        _keep(Span(self.name, threading.current_thread().name, self._start, end,
                   self._parent, self.ids))
        return False


def span(name: str, **ids):
    """A context manager that keeps ``name``'s span with ``ids`` if a
    profiler window is open when it begins; ``note(**ids)`` on what it
    yields adds ids."""
    if not tracing():
        return _OFF
    return _Span(name, ids)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` window around a code block (the host, and the
    card where there is one) → ``<log_dir>/trace.json``, a Chrome trace
    that also holds the spans the program kept in the window on other
    threads; yields the profiler, whose ``key_averages()`` sum the time by
    op."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    here = threading.current_thread().name
    t_open = time.time_ns()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    t_close = time.time_ns()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    # the window's own thread's spans are in the trace already (record_function)
    _add_spans(path, [s for s in spans()
                              if t_open <= s.start_ns <= t_close and s.thread != here])


def _add_spans(path: str, kept: list[Span]) -> None:
    """Write ``kept`` into the Chrome trace at ``path`` as complete host
    events on its time base (µs from ``baseTimeNanoseconds``), one row a
    thread."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    tids: dict[str, int] = {}
    events = trace.setdefault("traceEvents", [])
    for s in kept:
        if s.thread not in tids:
            tids[s.thread] = tid = (1 << 30) + len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                           "args": {"name": f"{s.thread} (program spans)"}})
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": tids[s.thread], "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": dict(s.ids)})
    with open(path, "w") as f:
        json.dump(trace, f)
