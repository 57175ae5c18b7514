"""The device trace of a ``--trace 1`` run.

``DeviceTrace`` opens a ``torch.profiler`` window (host and card) at a point
the traffic chooses and closes it after a device synchronise.  From the
profiler's raw events it keeps every operation that ran on the card (kernels,
copies, fills) as (name, start µs, duration µs), and the host's operations, so
that an idle gap on the card can be named by what the host was doing.

* ``busy_s``: the union of the device operations' intervals;
* ``window_s``: the traced window, open to close on the host's clock;
* ``family_s(patterns)``: the summed durations of the operations whose name
  holds one of ``patterns`` (a kernel family, by its kernel names: the kernels
  launch through ``ctypes``, so the profiler sees no ATen op of theirs);
* ``breakdown()``: the ten device operations that took most time, and the ten
  longest idle gaps, each named by the host operation that covered it.
"""

from __future__ import annotations

import time

import torch


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _kineto_events(prof):
    """(device ops, host ops): lists of (name, start µs, end µs).  A range
    annotated on the device's timeline (``Optimizer.step#AdamW.step``) is
    no operation and may span idle time: it is left out."""
    device, host = [], []
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if results is not None:
        for e in results.events():
            start = e.start_ns() / 1e3
            end = start + e.duration_ns() / 1e3
            if str(e.device_type()).endswith("CPU"):
                host.append((e.name(), start, end))
            elif not (getattr(e, "is_user_annotation", lambda: False)() or "#" in e.name()):
                device.append((e.name(), start, end))
        return device, host
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        kind = str(e.device_type)
        (host if kind.endswith("CPU") else device).append((e.name, start, end))
    return device, host


class DeviceTrace:
    def __init__(self):
        self._prof = None
        self.device_ops: list[tuple[str, float, float]] = []
        self.host_ops: list[tuple[str, float, float]] = []
        self.window_s = 0.0
        self.busy_s = 0.0

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self, sync: bool = True) -> None:
        """Open the window, after a device synchronise unless ``sync`` is
        false (a caller that may not wait for the card)."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        if sync:
            _sync()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        _sync()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self.device_ops, self.host_ops = _kineto_events(self._prof)
        self._prof = None
        self.device_ops.sort(key=lambda e: e[1])
        self.busy_s = self._union_s()

    def _union_s(self) -> float:
        total, cur_s, cur_e = 0.0, None, None
        for _, s, e in self.device_ops:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e6

    def family_s(self, patterns) -> float:
        return sum(e - s for name, s, e in self.device_ops
                   if any(p in name for p in patterns)) / 1e6

    def breakdown(self) -> dict:
        by_name: dict[str, float] = {}
        for name, s, e in self.device_ops:
            short = name.replace("(anonymous namespace)::", "").replace("void ", "")
            short = short.split("(")[0].split("<")[0].strip()[:80] or name[:80]
            by_name[short] = by_name.get(short, 0.0) + (e - s) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps, last_end = [], None
        for _, s, e in self.device_ops:
            if last_end is not None and s > last_end:
                gaps.append((last_end, s))
            last_end = e if last_end is None else max(last_end, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        named = []
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            cover = [h for h in self.host_ops if h[1] <= mid <= h[2]]
            # the innermost host operation spanning the gap's middle
            label = (min(cover, key=lambda h: h[2] - h[1])[0] if cover
                     else "host outside any profiled op (Python)")
            named.append([f"host: {label[:80]}", (g1 - g0) / 1e6])
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": named}
