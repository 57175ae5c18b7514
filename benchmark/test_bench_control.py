"""Each cell's control — the plain reference put in the program's place at
the next precision below the configuration's (int4 codes for the int8
products of a sweep, an embedding and the served path; int8 codes for every
product of a bf16 training step) — comes out not correct under the cell's
limits.  On the card ``readings.py --control`` reads it at the cells' own
sizes; here at the tiny sizes, on the CPU."""

import time

import pytest

import readings
import tiny
from harness import cell, spec


@pytest.mark.parametrize("name", ["design-exact", "pencl-embed", "design-serve", "stage3-train"])
def test_control_is_not_correct(name):
    c = tiny.shrink(spec.load_cell(name))
    controls = readings.controls_for(c.mix["kind"])
    ctx, outcome = cell.execute(c, 2 ** 36 + 3, 1.0, False, "cpu", time.perf_counter(), controls)
    assert all(ch.ok for ch in outcome.checks)          # the program itself passes
    limits = c.mix["limits"]
    for control in controls:
        read = ctx.readings[control]
        assert any(v > limits[k] for k, v in read.items()), (control, read, limits)
