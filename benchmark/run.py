"""The benchmark of the PyTorch/CUDA port (``biom3_tpu_torch``): one run of
one cell.

  python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell asks
for.  The cell, its configuration, its traffic and its metrics are found by
name (``BENCHMARK.json``, ``benchmark/harness/spec.py``).  The last line of
standard output is the result's JSON; the last lines of standard error are the
numbers compared, each beside its limit.  Without a card the run exits 2 and
prints no result.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import time


def _process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (from
    /proc/self/stat where there is one, else now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()
HERE = pathlib.Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]   # the harness, then the program
    from harness import cell

    return cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                    t_process=T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())
