"""Where the card's idle time goes in a traced run of one cell, by the
program's spans.

  python3 benchmark/span_report.py --workload <name> --seed <n> --seconds <s> [--out f.json]

Runs the cell as ``run.py --trace 1`` does, then prints one JSON line: the
end-to-end and per-layer metrics, ``correct``, and over the traced window
the card's idle seconds, those under each span name (nested spans count in
each), under the spans of the thread that does the work (every span but the
cross-thread ``serve.request`` and ``serve.queue``), and the spans kept a
second.  Needs a card, as ``run.py`` does.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from run import HERE, T_PROCESS

CROSS_THREAD = {"serve.request", "serve.queue"}


def attribution(trace) -> dict | None:
    from harness import spans

    win = spans.window_us(trace)
    kept = [s for s in spans.program_spans()
            if s.end_ns / 1e3 > win[0] and s.start_ns / 1e3 < win[1]] if win else []
    if not kept:
        return None
    idle_us = sum(e - s for s, e in spans.idle(trace, win))
    names = sorted({s.name for s in kept})
    by_name = {n: spans.idle_under(trace, [s for s in kept if s.name == n], win) / 1e6
               for n in names}
    working = [s for s in kept if s.name not in CROSS_THREAD]
    covered = spans.merged(map(spans.us, working))
    outside = [(s - win[0], e - s) for s, e in uncovered(spans.idle(trace, win), covered)]
    return {"window_s": trace.window_s, "idle_s": idle_us / 1e6,
            "idle_under_s": by_name,
            "idle_under_working_thread_share": spans.idle_under(trace, working, win) / idle_us
            if idle_us else None,
            "first_working_span_after_open_s": (min(s for s, _ in covered) - win[0]) / 1e6,
            "idle_outside_working_spans": [[o / 1e6, d / 1e6] for o, d in
                                           sorted(outside, key=lambda x: -x[1])[:5]],
            "spans_per_s": {n: sum(1 for s in kept if s.name == n) / trace.window_s
                            for n in names}}


def uncovered(gaps, covered):
    """The parts of the sorted intervals ``gaps`` outside the union
    ``covered`` (``spans.merged``'s)."""
    out, j = [], 0
    for g0, g1 in gaps:
        while j < len(covered) and covered[j][1] <= g0:
            j += 1
        at, k = g0, j
        while k < len(covered) and covered[k][0] < g1:
            if covered[k][0] > at:
                out.append((at, covered[k][0]))
            at = max(at, covered[k][1])
            k += 1
        if at < g1:
            out.append((at, g1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None, help="also write the line to this file")
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    from harness import cell, spec

    c = spec.load_cell(args.workload)
    missing = cell.require_cards(c.chips)
    if missing:
        print(f"span_report: {missing}", file=sys.stderr)
        return 2
    ctx, outcome = cell.execute(c, args.seed, args.seconds, True, "cuda", T_PROCESS)
    line = {"workload": c.name, "seed": args.seed, "card": cell.power_limit(),
            "correct": all(k.ok for k in outcome.checks) and bool(outcome.checks),
            "end_to_end": outcome.metrics,
            "per_layer": {m["name"]: spec.metric_reader(m["name"], c.bench_dir)(ctx)
                          for m in c.per_layer},
            "spans": attribution(ctx.trace)}
    text = json.dumps(cell._clean(line))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
