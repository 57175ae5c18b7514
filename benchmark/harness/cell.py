"""One run of one cell: set-up, the measured window, the check, the result line.

The traffic kind (``traffic/<kind>.py``) does the set-up and drives the
window; it returns an ``Outcome``: the end-to-end metrics it timed, what it
counted for the per-layer metrics, and the checks of what the timed path
produced against the plain reference.  This module adds the device's facts,
the per-layer metrics of a traced run, and prints:

* standard error, last lines: each number compared beside its limit;
* standard output, last line: ``{"correct", "attempted", "failed",
  "metrics", "device", ["breakdown"], "checks"}``.

A run without the cards it needs, or with JAX or the JAX package loaded once
the window has closed, prints no result and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys

import torch

from harness import spec
from harness.trace import DeviceTrace

FORBIDDEN = ("jax", "jaxlib", "flax", "biom3_tpu")


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float
    ok: bool


@dataclasses.dataclass
class Outcome:
    metrics: dict                 # end-to-end metric name → value
    attempted: int
    failed: int
    checks: list                  # [Check]
    memory_peak_bytes: int = 0


@dataclasses.dataclass
class Context:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: DeviceTrace | None     # None in an untraced run
    device: torch.device
    t_process: float              # the process's start on time.perf_counter()'s clock
    work: dict = dataclasses.field(default_factory=dict)   # counts for the metrics
    controls: dict = dataclasses.field(default_factory=dict)   # name → reference Precision
    readings: dict = dataclasses.field(default_factory=dict)   # "program" / control → numbers

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.mix


def check_le(name: str, value: float, limit: float) -> Check:
    """A number that must not exceed its limit (NaN fails)."""
    value = float(value)
    return Check(name, value, float(limit), bool(value <= limit))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``biom3_tpu_torch`` is not ``biom3_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def require_cards(chips: int) -> str | None:
    """None when ``chips`` CUDA devices are there, else why not."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false: no card, and no CPU fallback"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards, torch sees {torch.cuda.device_count()}"
    return None


def run(name: str, seed: int, seconds: float, trace: bool, *, t_process: float,
        device: str | None = None, root=None, cell: spec.Cell | None = None) -> int:
    """Run the cell and print its result; → the exit code.  ``device`` (the
    CPU tests' "cpu") skips the look for a card; a measured run passes
    None."""
    cell = spec.load_cell(name, root) if cell is None else cell
    if device is None:
        missing = require_cards(cell.chips)
        if missing:
            print(f"benchmark: {missing}", file=sys.stderr)
            return 2
        device = "cuda"
        print(f"card: {power_limit()}", file=sys.stderr)
    ctx, outcome = execute(cell, seed, seconds, trace, device, t_process)
    dev = ctx.device

    found = forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], cell.bench_dir)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.metrics[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    result = {"correct": all(c.ok for c in outcome.checks) and bool(outcome.checks),
              "attempted": int(outcome.attempted), "failed": int(outcome.failed),
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    for c in outcome.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(_clean(result), allow_nan=False))
    return 0


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
            t_process: float, controls: dict | None = None) -> tuple[Context, Outcome]:
    """Set up, measure and check one run of ``cell`` → (context, outcome)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ctx = Context(cell, seed, seconds, DeviceTrace() if trace else None, dev, t_process,
                  controls=dict(controls or {}))
    outcome = spec.traffic_kind(cell.mix["kind"], cell.bench_dir).run(ctx)
    print(f"run: {cell.name} seed {seed}: " + ", ".join(
        f"{k} {v!r}" for k, v in outcome.metrics.items()), file=sys.stderr)
    return ctx, outcome


def _clean(obj):
    """Numbers as plain floats, with a non-finite one (a failed reading) as
    null, so that the line is valid JSON."""
    if isinstance(obj, dict):
        return {k: _clean(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_clean(v) for v in obj]
    if isinstance(obj, bool) or obj is None or isinstance(obj, (str, int)):
        return obj
    x = float(obj)
    return x if math.isfinite(x) else None
