"""On the card: one short run of each cell through ``run.py`` prints a
correct result line.  Skips without a card (decided inside the test)."""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
CELLS = [w["name"] for w in json.loads((HERE.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", name,
                          "--seed", str(2 ** 33 + 101), "--seconds", "30", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=HERE.parent)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
