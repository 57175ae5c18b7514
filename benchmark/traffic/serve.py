"""The serving daemon under an open loop: the served tail of ``run_server``.

The program: ``cli/run_server.build_server`` under a preset (``latency``:
blocked path order, k = 8, temperature 0, the trajectory scheduler, 32 rows a
dispatch), in process, its three engines on seeded weights, bound to a free
local port, warmed (``server.warmup``: one dispatch of every device path it
serves), then ``POST /v1/generate`` over HTTP.

The traffic: ``round(rate · seconds)`` requests due in the window, Poisson
arrivals at the fixed ``rate_per_s`` (``harness/openloop.py``: the seed orders
a fixed set of gaps), each ``{"prompt", "num_replicas", "seed"}`` with the
prompt drawn Zipf(``zipf_s``) from a pool of ``prompt_pool`` seeded captions
(log-normal lengths in wordpieces, each word one entry of the benchmark's
PubMedBERT-sized vocabulary), so the embed cache sees repeats.  Each latency
runs from the request's due time to its full reply; a failed or refused
request counts as failed and as missing every limit.  ``serve_p95_s`` is the
95th percentile over all requests due in the window, after every one of them
has been answered.

The check, once all are answered:

* ``missing``: requests that failed or got no answer;
* ``shape_err``: replies with the wrong count of designs or a letter outside
  the decode table's residues;
* ``zc_err``: for the prompts of the sampled rows, the largest
  ‖z_c − reference‖ / ‖reference‖, the program's z_c read back from
  ``/v1/embed`` (the embed cache holds the served values), the reference's
  worked out from the prompt: BERT, the text projection, the Facilitator;
* ``served_gap``: for ``check_rows`` rows of the window's dispatches (kept
  as the trajectory dispatch returned them, with their decode order) and
  ``check_steps`` of their steps (the last always), the state before the
  step rebuilt from the served tokens, the reference's logits at the step's
  positions (the server's own positions per step): the largest gap by which
  a served token's logit lies below the reference's best.

A traced run traces the last ``trace_seconds`` of the arrivals, when the
scheduler has long had its backlog: the client's thread opens the trace at
its first send past that point, without waiting for the card, and closes it
after its last send.  Closing it holds the interpreter for seconds, which
would hold back every send due after it: at the end only replies still in
flight wait.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import math
import pathlib
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from harness import draws, models, openloop
from harness.cell import Outcome, check_le
from reference import pencl as ref1
from reference import proteoscribe as ref3
from reference.common import strict_f32

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
CLS, SEP = 2, 3
DECODED = set("ACDEFGHIKLMNPQRSTVWYXUZBO-")    # the decode table's letters, '-' absorbing


def write_vocab(path: pathlib.Path, size: int) -> list[str]:
    """A PubMedBERT-sized wordpiece vocabulary: the specials, the printable
    characters and their ## twins, then distinct lower-case pieces of 2–12
    letters (English-like letter weights, some as ## suffixes) from a fixed
    seed.  → the vocabulary."""
    chars = sorted({chr(c) for c in range(33, 127)} | {chr(c) for c in range(97, 123)})
    vocab = SPECIALS + chars + ["##" + c for c in chars if c.isalnum()]
    seen = set(vocab)
    r = np.random.default_rng(0)
    letters = np.array(list("etaoinshrdlucmfwypvbgkjqxz"))
    weights = np.linspace(2.0, 0.2, len(letters))
    weights /= weights.sum()
    while len(vocab) < size:
        w = "".join(r.choice(letters, size=int(r.integers(2, 13)), p=weights))
        if r.random() < 0.35:
            w = "##" + w
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": True, "model_max_length": 512}))
    return vocab


def make_prompts(seed: int, mix: dict, vocab: list[str]) -> list[tuple[str, list[int]]]:
    """The pool of captions: (text, word ids), whole words of the vocabulary
    separated by spaces, lengths at fixed log-normal quantiles (with [CLS]
    and [SEP]) in the seed's order."""
    words = [i for i, w in enumerate(vocab) if len(w) >= 2 and w.isalpha() and w.islower()]
    r = draws.rng(seed, 6)
    lengths = r.permutation(draws.lognormal_lengths(int(mix["prompt_pool"]),
                                                    **mix["caption_length"]))
    pool = []
    for n in lengths:
        ids = r.choice(words, size=int(n) - 2).tolist()
        pool.append((" ".join(vocab[i] for i in ids), ids))
    return pool


class Server:
    """The daemon in process on seeded weights, and its kept dispatches."""

    def __init__(self, ctx, workdir: pathlib.Path):
        mix, cfg = ctx.mix, ctx.config
        from biom3_tpu_torch.cli import run_server
        from biom3_tpu_torch.pipeline import stage1, stage2, stage3

        self.vocab = write_vocab(workdir / "vocab", int(cfg["stage1"]["bert_vocab_size"]))
        s1 = {**cfg["stage1"], "text_model_path": str(workdir / "vocab")}
        self.s1, self.s2, self.s3 = s1, cfg["stage2"], cfg["stage3"]
        paths = {}
        for i, section in ((1, s1), (2, self.s2), (3, self.s3)):
            paths[i] = workdir / f"stage{i}.json"
            paths[i].write_text(json.dumps(section))
        dev = ctx.device
        self.states = {
            1: models.seeded_state(ref1.text_layout(s1), draws.sub_seed(ctx.seed, 0, 1), dev),
            2: models.seeded_state(ref1.facilitator_layout(self.s2),
                                   draws.sub_seed(ctx.seed, 0, 2), dev, torch.float32),
            3: models.seeded_state(ref3.layout(self.s3), draws.sub_seed(ctx.seed, 0, 3), dev)}
        argv = ["--device", str(dev.type), "--port", "0", "--preset", mix["preset"],
                "--num_replicas", str(mix["num_replicas"])]
        for i in (1, 2, 3):
            argv += [f"--stage{i}_json", str(paths[i]), f"--stage{i}_model", models.SEEDED]
        args = run_server.parse_arguments(argv)
        if args.sampler != "ardm" or args.decode_order != "path":
            raise ValueError("the served-token check rebuilds each state along the decode "
                             f"path; preset {mix['preset']!r} serves another order")
        self.k = int(args.positions_per_step)
        self.kept: list[tuple] = []
        self.keep = False
        self._keep_lock = threading.Lock()

        def keeping(original):
            def make_row_fn(engine, mesh=None):
                row_fn = original(engine, mesh)

                def kept_row_fn(z_c, inv, key_data, masked=None):
                    ids = row_fn(z_c, inv, key_data, masked)
                    if self.keep:
                        with self._keep_lock:
                            self.kept.append((np.array(z_c), np.array(inv), ids.clone()))
                    return ids

                kept_row_fn.accepts_masked = row_fn.accepts_masked
                return kept_row_fn
            return make_row_fn

        with contextlib.ExitStack() as stack:
            for module, i in ((stage1, 1), (stage2, 2), (stage3, 3)):
                stack.enter_context(models.engine_loading(module, self.states[i]))
            stack.enter_context(models.patched(stage3.ProteoScribeEngine,
                                               "make_trajectory_row_fn", keeping))
            self.server = run_server.build_server(args)
        self.server.warmup()
        self.server.start()
        self.port = self.server.port
        self.rows = self.server.pipeline.rows_per_dispatch

    def post(self, path: str, body: dict, timeout: float = 600.0):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=timeout)
        try:
            conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            return resp.status == 200, json.loads(data) if data else None
        finally:
            conn.close()

    def close(self):
        self.server.close()


def schedule(seed: int, mix: dict, rate: float, seconds: float, pool) -> list:
    r = draws.rng(seed, 7)
    offsets = openloop.arrival_offsets(r, rate, seconds)
    ranks = draws.zipf_ranks(r, len(offsets), len(pool), float(mix["zipf_s"]))
    seeds = r.integers(0, 2 ** 32, size=len(offsets))
    return [(float(off), {"prompt": pool[int(k)][0], "num_replicas": int(mix["num_replicas"]),
                          "seed": int(s)}) for off, k, s in zip(offsets, ranks, seeds)]


def measure(ctx, srv: Server, rate: float, seconds: float, pool, trace=None) -> dict:
    """One open-loop window at ``rate``; → latencies, counters and replies."""
    plan = schedule(ctx.seed, ctx.mix, rate, seconds, pool)
    stats0 = srv.server.pipeline.device_stats()
    loop = openloop.OpenLoop(lambda req: srv.post("/v1/generate", req))
    t0 = time.perf_counter() + 0.05
    trace_from = t0 + seconds - min(float(ctx.mix["trace_seconds"]), seconds)
    sent = [0]

    def on_send(t):
        sent[0] += 1
        if trace is None:
            return
        if sent[0] == len(plan):
            if trace.active:
                trace.stop()
        elif not trace.active and t >= trace_from:
            trace.start(sync=False)

    srv.keep = True
    records = loop.run(t0, plan, on_send)
    srv.keep = False
    stats1 = srv.server.pipeline.device_stats()
    return {"records": records, "plan": plan, "t0": t0,
            "dispatches": stats1["dispatches"] - stats0["dispatches"],
            "rows_live": stats1["rows_live"] - stats0["rows_live"]}


def run(ctx) -> Outcome:
    mix = ctx.mix
    with tempfile.TemporaryDirectory(prefix="bench_serve_") as tmp:
        srv = Server(ctx, pathlib.Path(tmp))
        try:
            pool = make_prompts(ctx.seed, mix, srv.vocab)
            if ctx.trace is not None:
                ctx.trace.start()          # the profiler's first start-up stays out of the window
                ctx.trace.stop()
            t_open = time.perf_counter()
            res = measure(ctx, srv, float(mix["rate_per_s"]), ctx.seconds, pool, ctx.trace)
            peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
            records = res["records"]
            lat = [r.latency for r in records]
            ctx.work.update(latencies=lat, dispatches=res["dispatches"],
                            rows_live=res["rows_live"], rows=srv.rows)
            metrics = {"serve_p95_s": openloop.percentile(lat, 0.95),
                       "setup_s": t_open - ctx.t_process}
            failed = sum(1 for r in records if not r.ok)
            print("serve: first five latencies " + ", ".join(f"{x:.3f}" for x in lat[:5])
                  + f" s; p50 {openloop.percentile(lat, 0.5):.3f} s; generator late by at "
                  f"most {openloop.lateness(records):.3f} s", file=sys.stderr)
            served = sorted({req["prompt"] for (_, req), r in zip(res["plan"], records) if r.ok})
            ok_e, embed = srv.post("/v1/embed", {"prompts": served}) if served else (False, None)
            program_zc = ({p: np.asarray(row["z_c"], np.float32)
                           for p, row in zip(served, embed["results"])} if ok_e else {})
        finally:
            srv.close()
    readings = check(ctx, srv, res, pool, program_zc)
    checks = [check_le(n, v, mix["limits"][n]) for n, v in readings.items()]
    return Outcome(metrics, attempted=len(records), failed=failed, checks=checks,
                   memory_peak_bytes=peak)


def text_ids(words: list[int], pad: int) -> torch.Tensor:
    ids = [CLS] + list(words) + [SEP]
    return torch.as_tensor(ids + [0] * (pad - len(ids)), dtype=torch.long)[None]


@torch.no_grad()
def check(ctx, srv: Server, res: dict, pool, program_zc: dict) -> dict:
    """The program's numbers; each control's (``zc_err``, ``served_gap``:
    the gap of the token the control puts first) go to ``ctx.readings``."""
    strict_f32()
    mix, dev = ctx.mix, ctx.device
    records, plan = res["records"], res["plan"]
    missing = sum(1 for r in records if not r.ok)
    shape_err = 0
    for (_, req), r in zip(plan, records):
        if not r.ok:
            continue
        seqs = r.reply["results"][0]["sequences"]
        shape_err += int(len(seqs) != req["num_replicas"]
                         or any(set(s) - DECODED for s in seqs))
    out = {"missing": float(missing), "shape_err": float(shape_err)}
    words = {text: ids for text, ids in pool}
    by_zc = {zc.tobytes(): p for p, zc in program_zc.items()}
    kept = [(zc[i], inv[i], ids[i]) for zc, inv, ids in srv.kept for i in range(len(zc))
            if zc[i].tobytes() in by_zc]
    r = draws.rng(ctx.seed, 8)
    picks = r.choice(len(kept), size=min(int(mix["check_rows"]), len(kept)), replace=False)
    rows = [kept[i] for i in picks]
    prompts = sorted({by_zc[zc.tobytes()] for zc, _, _ in rows})
    pad = int(srv.s1["text_max_length"])
    ref_zc = {}
    zc_err = 0.0
    ctl = {name: {"zc_err": 0.0, "served_gap": 0.0} for name in ctx.controls}

    def zc_of(p, prec=None):
        ids = text_ids(words[p], pad).to(dev)
        if prec is None:
            return ref1.facilitator(srv.states[2], ref1.z_t(srv.states[1], srv.s1, ids))[0]
        return ref1.facilitator(srv.states[2], ref1.z_t(srv.states[1], srv.s1, ids, prec),
                                prec)[0]

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    for p in prompts:
        ref_zc[p] = zc_of(p)
        zc_err = max(zc_err, rel(torch.as_tensor(program_zc[p], device=dev), ref_zc[p]))
        for name, prec in ctx.controls.items():
            ctl[name]["zc_err"] = max(ctl[name]["zc_err"], rel(zc_of(p, prec), ref_zc[p]))
    out["zc_err"] = zc_err if prompts else math.nan
    k = srv.k
    L = ref3.dims(srv.s3)["L"]
    steps = L // k
    n_steps = int(mix["check_steps"])
    chosen = [steps - 1] + r.choice(steps - 1, size=n_steps - 1, replace=False).tolist()
    gap = 0.0
    if rows:
        z_c = torch.stack([ref_zc[by_zc[zc.tobytes()]] for zc, _, _ in rows])
        inv = torch.as_tensor(np.stack([v for _, v, _ in rows]), device=dev).long()
        ids = torch.stack([i.to(dev) for _, _, i in rows]).long()
        rank = torch.empty_like(inv).scatter_(1, inv, torch.arange(L, device=dev).expand_as(inv))
        for s in chosen:
            x = torch.where(rank < s * k, ids, torch.zeros_like(ids))
            pos = inv[:, s * k:(s + 1) * k]
            t = torch.full((len(rows),), s * k, dtype=torch.long, device=dev)
            lg = ref3.logits_at(srv.states[3], srv.s3, x, t, z_c, pos)
            best = lg.max(-1).values
            served = lg.gather(-1, ids.gather(1, pos)[..., None])[..., 0]
            gap = max(gap, float((best - served).max()))
            for name, prec in ctx.controls.items():
                first = ref3.logits_at(srv.states[3], srv.s3, x, t, z_c, pos, prec).argmax(-1)
                g = float((best - lg.gather(-1, first[..., None])[..., 0]).max())
                ctl[name]["served_gap"] = max(ctl[name]["served_gap"], g)
    out["served_gap"] = gap if rows else math.nan
    ctx.readings.update({"program": out, **ctl})
    return out
