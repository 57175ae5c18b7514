"""Nothing the benchmark runs loads JAX or the JAX package, and the
references load nothing of the program.  Top-level module names are compared
whole: ``biom3_tpu_torch`` begins with ``biom3_tpu`` and is not it."""

import ast
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "biom3_tpu"}

DRY_RUN = r'''
import json, pathlib, sys, time
here = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(here), str(here.parent)]
import tiny
from harness import cell, faults, spec, trace, roofline, draws, models
import readings, run
bench = json.loads((here.parent / "BENCHMARK.json").read_text())
for kind in sorted({spec.load_cell(w["name"]).mix["kind"] for w in bench["workloads"]}):
    spec.traffic_kind(kind)
for m in bench["per_layer"]:
    spec.metric_reader(m["name"])
for p in sorted((here / "reference").glob("*.py")):
    __import__("reference." + p.stem)
c = tiny.shrink(spec.load_cell("design-exact"))
ctx, outcome = cell.execute(c, 2 ** 34 + 9, 0.5, True, "cpu", time.perf_counter())
assert all(ch.ok for ch in outcome.checks)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
'''

REFERENCE_ONLY = r'''
import json, pathlib, sys
here = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(here)]
for p in sorted((here / "reference").glob("*.py")):
    __import__("reference." + p.stem)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
'''


def _top_level(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code, str(HERE)], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_a_dry_run_load_no_jax():
    loaded = _top_level(DRY_RUN)
    assert "biom3_tpu_torch" in loaded        # the program ran
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_references_load_nothing_of_the_program():
    loaded = _top_level(REFERENCE_ONLY)
    assert not loaded & (FORBIDDEN | {"biom3_tpu_torch"}), loaded


def test_reference_sources_import_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN | {"biom3_tpu_torch"}, (path, name)
