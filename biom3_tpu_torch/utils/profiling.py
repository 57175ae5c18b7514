"""Profiling and device-memory observability.

Port of ``biom3_tpu/utils/profiling.py`` (the reference's pynvml/psutil
probes, ``Stage1_source/helper_funcs.py:11-31``): the card's memory from
the CUDA caching allocator (``torch.cuda.memory_stats``), a
``torch.profiler`` window that writes a Chrome trace, the process RSS and
a wall-clock step timer.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

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


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` window around a code block (the host, and the
    card where there is one) → ``<log_dir>/trace.json``, a Chrome trace;
    yields the profiler, whose ``key_averages()`` sum the time by op."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock per-step timing with warmup discard."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._t0 = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")
