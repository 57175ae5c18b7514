"""Readings that the limits of ``correct`` are set from, many seeds in one
process (run on the card; the benchmark's own runs never run this).

  python3 benchmark/readings.py --workload <name> --seeds 1,2,3 --seconds 25 \\
      [--control] [--fault <name of harness/faults.py>] --out f.jsonl

For each seed: one run of the cell at its own sizes with a window of
``--seconds`` (long enough for the mix's longest work to finish), then the
numbers compared for the program and, with ``--control``, for the control:
the plain reference put in the program's place at the next precision below
the one the configuration states — int4 codes for the products the program
runs in int8 (a sweep, an embedding), int8 codes for every product of a step
the program trains in bf16.  ``--fault`` plants a fault of
``harness/faults.py`` under the timed path.  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent


def controls_for(kind: str) -> dict:
    from reference.common import ALL_KINDS, Precision

    if kind == "train":
        return {"control_int8": Precision(bits=8, kinds=ALL_KINDS)}
    return {"control_int4": Precision(bits=4, kinds=("proj", "ff"))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import contextlib

    from harness import cell, faults, spec

    c = spec.load_cell(args.workload)
    kind = c.mix["kind"]
    controls = controls_for(kind) if args.control else {}
    with open(args.out, "a") as out:
        for seed in (int(s) for s in args.seeds.split(",")):
            planted = (faults.planted(args.fault, kind) if args.fault
                       else contextlib.nullcontext())
            with planted:
                ctx, outcome = cell.execute(c, seed, args.seconds, False, args.device,
                                            time.perf_counter(), controls)
            line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                    "metrics": outcome.metrics, "readings": ctx.readings,
                    "correct": all(ch.ok for ch in outcome.checks)}
            out.write(json.dumps(line) + "\n")
            out.flush()
            print(json.dumps(line), flush=True)
            del ctx, outcome
    return 0


if __name__ == "__main__":
    sys.exit(main())
