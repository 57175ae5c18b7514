"""The serving cell's knee: the highest open-loop rate the daemon sustains.

  python3 benchmark/knee.py --workload design-serve --rates 3,4,5,6 --seconds 30 --out f.jsonl

Sets the daemon up once as the cell does, then for each rate one open-loop
window of ``--seconds``: requests, p50 and p95 latency (from due time),
replies a second, the generator's lateness, and the backlog's growth (the
mean latency of the window's last tenth of requests over its first tenth's).
A rate is sustained while that growth stays near 1.  The cell's own rate is
fixed in its mix file at about four fifths of the knee found here.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="design-serve")
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, default=2 ** 33 + 17)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import numpy as np
    import torch

    from harness import cell, openloop, spec
    from traffic import serve

    c = spec.load_cell(args.workload)
    ctx = cell.Context(c, args.seed, args.seconds, None, torch.device("cuda"),
                       time.perf_counter())
    with tempfile.TemporaryDirectory(prefix="bench_knee_") as tmp, open(args.out, "a") as out:
        srv = serve.Server(ctx, pathlib.Path(tmp))
        try:
            pool = serve.make_prompts(args.seed, c.mix, srv.vocab)
            for rate in (float(r) for r in args.rates.split(",")):
                res = serve.measure(ctx, srv, rate, args.seconds, pool)
                srv.kept.clear()
                recs = res["records"]
                lat = [r.latency for r in recs]
                tenth = max(1, len(lat) // 10)
                ok = [r for r in recs if r.ok]
                line = {"rate": rate, "requests": len(recs), "failed": len(recs) - len(ok),
                        "p50_s": openloop.percentile(lat, 0.5),
                        "p95_s": openloop.percentile(lat, 0.95),
                        "replies_per_s": len(ok) / (max(r.done for r in ok) - res["t0"]),
                        "lateness_s": openloop.lateness(recs),
                        "growth": float(np.mean(lat[-tenth:]) / np.mean(lat[:tenth])),
                        "occupancy": res["rows_live"] / max(1, res["dispatches"] * srv.rows)}
                out.write(json.dumps(line) + "\n")
                out.flush()
                print(json.dumps(line), flush=True)
        finally:
            srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
