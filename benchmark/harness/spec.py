"""What a cell is made of, found by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix; everything else is a file of its own under the
benchmark's folder:

* ``configs/<config>.json`` — the configuration as it is run;
* ``mixes/<traffic>.json`` — the traffic mix's parameters, with ``kind``;
* ``traffic/<kind>.py`` — the generator of that kind of traffic, which runs the program;
* ``metrics/<metric>.py`` — one per-layer metric, a ``read(ctx)`` function.

A cell, a configuration, a mix or a metric is added by adding files and
entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list[dict]     # the cell's end-to-end metrics
    per_layer: list[dict]      # the cell's per-layer metrics
    bench_dir: pathlib.Path    # the benchmark's folder in the checkout


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reported_in(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, root: pathlib.Path | None = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files under
    ``<root>/benchmark``."""
    root = BENCH_DIR.parent if root is None else pathlib.Path(root)
    bench_dir = root / BENCH_DIR.name
    bench = _load_json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {[w['name'] for w in bench['workloads']]})")
    w = entries[0]
    config = _load_json(bench_dir / "configs" / f"{w['config']}.json")
    mix = _load_json(bench_dir / "mixes" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reported_in(m, name, names)]
    return Cell(name, int(w["chips"]), config, mix, e2e, per_layer, bench_dir)


def _load_module(path: pathlib.Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def traffic_kind(kind: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The module of ``traffic/<kind>.py``: ``run(ctx) -> Outcome``."""
    return _load_module(bench_dir / "traffic" / f"{kind}.py", f"bench_traffic_{kind}")


def metric_reader(name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The ``read(ctx) -> float | None`` of ``metrics/<name>.py``."""
    safe = name.replace(".", "_").replace("-", "_")
    return _load_module(bench_dir / "metrics" / f"{name}.py", f"bench_metric_{safe}").read
