"""Offline generation sweep: design throughput of ProteoScribe.

The program: ``pipeline/sweep.SweepRunner`` over the stack forward that
``ProteoScribeEngine`` builds at its card defaults (``make_stack_apply``: int8
FF and projections, bf16 attention, tanh GELU), exact OA-ARDM path order.
Each batch is ``prompts`` seeded condition vectors × ``replicas`` rows, a new
batch each time, ``L / positions_per_step`` forwards a batch.

The window opens after the set-up (the engine, the kernels' load, a warm-up of
``warmup_forwards`` forwards at the window's shapes) and closes at the first
chunk boundary (``chunk_steps`` forwards, a device synchronise) after
``--seconds``; positions committed in it count, so a batch cut by the close
counts its part.  ``designs_per_s`` = forwards × rows × positions a forward /
L / the window's seconds.

The check, once the window has closed and the program is freed: at
``check_steps`` pairs of consecutive steps of each batch, drawn from the seed
(the last two always), the stack forward's logits at the gathered positions
and the state it was given are kept; the plain reference computes its logits
on that state.  A step's draws are read off the next step's state (or the
final ids), so a batch cut by the window's close is checked too.

* ``logit_err``: the largest |program − reference| logit;
* ``top_gap``: the largest gap by which the logit of the program's first
  token lies below the reference's best;
* ``commit_err``: positions where the state after a kept step differs from
  the state before it other than by the step's draws at its positions, and
  (finished batches) where a kept state differs from the final ids on the
  positions its path committed before it or holds a token on one not yet
  committed;
* at temperature > 0, ``draw_z``: |z| of the drawn tokens' reference
  log-likelihood against its expectation (the reference's entropy), over the
  kept steps' draws — a sampler that alters its draws moves it;
* at temperature 0, ``served_gap``: the largest gap by which a committed
  token's reference logit lies below the reference's best.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from harness import draws, models
from harness.cell import Outcome, check_le
from reference import proteoscribe as ref
from reference.common import strict_f32


class WindowClosed(Exception):
    """Raised at a chunk boundary to close the window (or end a warm-up)."""


class ForwardTap:
    """The engine's stack forward as the runner calls it, counted; each
    chunk boundary calls ``on_boundary``; the steps in ``capture`` keep
    their state and logits.  ``wrap_sampler`` keeps each batch's condition,
    path and final ids."""

    def __init__(self, apply, chunk: int):
        self.apply, self.chunk = apply, chunk
        self.step = 0
        self.forwards = 0
        self.on_boundary = None
        self.capture: set[int] = set()
        self.pick_steps = lambda batch: set()
        self.batches: list[dict] = []
        self.keep = False

    def __call__(self, x, t, z_c, pos):
        if self.step % self.chunk == 0 and self.on_boundary is not None:
            self.on_boundary()
        out = self.apply(x, t, z_c, pos)
        if self.keep and self.step in self.capture:
            self.batches[-1]["steps"].append((self.step, x.clone(), pos.clone(), out.clone()))
        self.step += 1
        self.forwards += 1
        return out

    def wrap_sampler(self, sampler):
        def sample(z_c, path, generator=None, **kw):
            self.step = 0
            self.capture = self.pick_steps(len(self.batches))
            if self.keep:
                self.batches.append({"z_c": z_c.clone(), "path": path.clone(), "steps": [],
                                     "ids": None})
            ids = sampler(z_c, path, generator, **kw)
            if self.keep:
                self.batches[-1]["ids"] = ids.clone()
            return ids

        return sample


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(ctx) -> Outcome:
    mix, s3 = ctx.mix, ctx.config["stage3"]
    dev = ctx.device
    dims = ref.dims(s3)
    L, k = dims["L"], int(mix["positions_per_step"])
    prompts, replicas = int(mix["prompts"]), int(mix["replicas"])
    rows, chunk = prompts * replicas, int(mix["chunk_steps"])
    temperature = float(mix["temperature"])
    outer = L // k

    # --- set-up -----------------------------------------------------------
    from biom3_tpu_torch.pipeline.sweep import SweepRunner

    state = models.seeded_state(ref.layout(s3), draws.sub_seed(ctx.seed, 0), dev)
    engine = models.proteoscribe_engine(s3, state, dev)
    tap = ForwardTap(engine._apply_fn, chunk)
    runner = SweepRunner(tap, L, device=dev, temperature=temperature, chunk_steps=chunk,
                         positions_per_step=k, apply_takes_positions=True)
    runner.sampler = tap.wrap_sampler(runner.sampler)
    r_check = draws.rng(ctx.seed, 3)
    n_check = int(mix["check_steps"])

    def pick_steps(b: int) -> set:
        """The last two steps and ``check_steps - 1`` more pairs of
        consecutive steps, drawn from the seed."""
        firsts = r_check.choice(outer - 2, size=n_check - 1, replace=False).tolist()
        return {outer - 2, outer - 1} | {s + d for s in firsts for d in (0, 1)}

    tap.pick_steps = pick_steps

    def condition(b: int) -> np.ndarray:
        return draws.rng(ctx.seed, 1, b).standard_normal((prompts, dims["cond"]),
                                                          dtype=np.float32)

    warm = int(mix["warmup_forwards"])

    def end_warmup():
        if tap.forwards >= warm:
            raise WindowClosed

    tap.on_boundary = end_warmup
    tap.chunk = max(1, min(chunk, warm))
    try:
        runner.run(condition(-1), num_replicas=replicas, seed=draws.sub_seed(ctx.seed, 2, -1),
                   device_batch=rows)
    except WindowClosed:
        pass
    tap.chunk = chunk
    _sync(dev)

    # --- the window ---------------------------------------------------------
    trace = ctx.trace
    if trace is not None:
        trace.start()       # the profiler's start-up stays out of the window
    t_open = time.perf_counter()
    deadline = t_open + ctx.seconds
    trace_end = t_open + float(mix["trace_seconds"])
    tap.forwards, tap.keep = 0, True
    traced = {}

    def boundary():
        _sync(dev)
        t = time.perf_counter()
        if trace is not None and trace.active and t >= trace_end:
            trace.stop()
            traced["forwards"] = tap.forwards
        if t >= deadline:
            raise WindowClosed

    tap.on_boundary = boundary
    b = 0
    try:
        while True:
            runner.run(condition(b), num_replicas=replicas, seed=draws.sub_seed(ctx.seed, 2, b),
                       device_batch=rows)
            b += 1
    except WindowClosed:
        t_close = time.perf_counter()
    if trace is not None and trace.active:
        trace.stop()
        traced["forwards"] = tap.forwards
    window_s = t_close - t_open
    forwards = tap.forwards
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    ctx.work.update(forwards=traced.get("forwards", 0), rows=rows, gathered=k, dims=dims)
    metrics = {"designs_per_s": forwards * rows * k / L / window_s,
               "setup_s": t_open - ctx.t_process}

    # --- the check ------------------------------------------------------------
    batches = tap.batches
    del runner, tap, engine
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    strict_f32()
    readings = read_batches(batches, state, s3, k, temperature)
    ctx.readings["program"] = readings
    for name, prec in ctx.controls.items():
        def candidate(x, t, zc, pos, prec=prec):
            return ref.logits_at(state, s3, x, t, zc, pos, prec)
        r = read_batches(batches, state, s3, k, temperature, candidate=candidate)
        ctx.readings[name] = {n: r[n] for n in ("logit_err", "top_gap")}
    checks = [check_le(n, v, mix["limits"][n]) for n, v in readings.items()]
    return Outcome(metrics, attempted=len(batches) * rows, failed=0, checks=checks,
                   memory_peak_bytes=peak)


@torch.no_grad()
def read_batches(batches, state, s3, k: int, temperature: float, candidate=None) -> dict:
    """The numbers compared, from the kept steps.  ``candidate(x, t, z_c,
    pos)`` gives the logits judged, the program's kept ones by default (a
    control puts the reference at a lower precision there).  A step's draws
    are read off the next step's state, or off the final ids for the last
    step of a finished batch."""
    logit_err = top_gap = served_gap = 0.0
    commit_err = 0
    z_num = z_var = 0.0
    for batch in batches:
        zc, ids = batch["z_c"], batch["ids"]
        kept = {step: (x, pos, out) for step, x, pos, out in batch["steps"]}
        inv = torch.argsort(batch["path"].long(), dim=-1)
        for step, (x, pos, out) in sorted(kept.items()):
            pos = pos.long()
            t = torch.full((x.shape[0],), step * k, dtype=torch.int64, device=x.device)
            lg_ref = ref.logits_at(state, s3, x, t, zc, pos)
            lg = out.float() if candidate is None else candidate(x, t, zc, pos)
            logit_err = max(logit_err, float((lg - lg_ref).abs().max()))
            best = lg_ref.max(-1).values
            first = lg_ref.gather(-1, lg.argmax(-1, keepdim=True))[..., 0]
            top_gap = max(top_gap, float((best - first).max()))
            if ids is not None:
                # the state before this step: the final ids on the positions
                # committed earlier in the path, the absorbing state elsewhere
                done = torch.zeros_like(x, dtype=torch.bool).scatter_(1, inv[:, :step * k], True)
                commit_err += int((x != torch.where(done, ids, torch.zeros_like(ids))).sum())
            if step + 1 in kept:
                after = kept[step + 1][0]
                drawn = after.gather(1, pos)
                commit_err += int((after != x.scatter(1, pos, drawn)).sum())
            elif ids is not None:
                drawn = ids.gather(1, pos)
            else:
                continue
            if temperature == 0.0:
                got = lg_ref.gather(-1, drawn.long()[..., None])[..., 0]
                served_gap = max(served_gap, float((best - got).max()))
            else:
                logp = torch.log_softmax(lg_ref / temperature, dim=-1)
                p = logp.exp()
                ent = -(p * logp).sum(-1)
                z_num += float((logp.gather(-1, drawn.long()[..., None])[..., 0] + ent).sum())
                z_var += float(((p * logp * logp).sum(-1) - ent * ent).sum())
    out = {"logit_err": logit_err, "top_gap": top_gap, "commit_err": float(commit_err)}
    if temperature == 0.0:
        out["served_gap"] = served_gap
    else:
        out["draw_z"] = abs(z_num) / math.sqrt(z_var) if z_var > 0 else float("nan")
    return out
