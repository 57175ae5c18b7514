"""Each cell's comparison catches the faults its program can have: a run on
the CPU at tiny sizes (the look for a card skipped), with the timed path
broken underneath, comes out not correct."""

import time

import pytest

import tiny
from harness import cell, faults, spec

CASES = [
    ("design-exact", "unchanged_step"),
    ("design-exact", "half_batch"),
    ("design-exact", "token_altered"),
    ("design-serve", "unchanged_step"),
    ("design-serve", "half_batch"),
    ("design-serve", "token_altered"),
    ("pencl-embed", "half_batch"),
    ("pencl-embed", "token_altered"),
    ("stage3-train", "unchanged_step"),
    ("stage3-train", "half_batch"),
    ("stage3-train", "ema_skipped"),
]


@pytest.mark.parametrize("name,fault", CASES)
def test_planted_fault_is_not_correct(name, fault):
    c = tiny.shrink(spec.load_cell(name))
    with faults.planted(fault, c.mix["kind"]):
        ctx, outcome = cell.execute(c, 2 ** 35 + 5, 1.0, False, "cpu", time.perf_counter())
    failed = [ch.name for ch in outcome.checks if not ch.ok]
    assert failed, (fault, ctx.readings)
