"""Bulk embedding of (caption, protein) pairs: PenCL pairs per second.

The program: ``pipeline/sweep.Stage1SweepRunner`` over a ``PenCLEngine`` at
its card defaults (the fused tower kernels, int8 FF and projections in both
towers, tanh GELU), ``device_batch`` pairs a slab.

The pairs are made from the seed before the window (tokenization stays out of
it): protein lengths at fixed log-normal quantiles (Swiss-Prot-like), the seed
ordering them, residues drawn from the 20 amino acids, as ESM ids <cls> … <eos>
padded to ``protein_pad``; caption lengths the same way in wordpieces, ids
[CLS] … [SEP] drawn from the vocabulary's word range, padded to
``caption_pad``.  ``pool_slabs`` slabs are made and the window cycles through
them.  ``pairs_per_s`` = pairs whose z_t and z_p are on the host ÷ the
window's seconds; the window closes when the slab running at ``--seconds``
has come back.

The check, once the window has closed: ``check_pairs`` pairs drawn from the
seed among those embedded (the longest protein always), the plain reference's
z_t and z_p beside the program's: ``zt_err`` and ``zp_err``, the largest
‖program − reference‖ / ‖reference‖ over them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import draws, models
from harness.cell import Outcome, check_le
from reference import pencl as ref
from reference.common import strict_f32

ESM_CLS, ESM_PAD, ESM_EOS = 0, 1, 2
ESM_AA = np.arange(4, 24)           # fair-esm's 20 standard residues
BERT_CLS, BERT_SEP, BERT_PAD, BERT_FIRST_WORD = 2, 3, 0, 5


def make_slab(seed: int, index: int, mix: dict, vocab: int) -> dict:
    """One slab of pairs: ESM ids (N, protein_pad), wordpiece ids (N,
    caption_pad), the real lengths."""
    n = int(mix["device_batch"])
    r = draws.rng(seed, 1, index)
    plen = r.permutation(draws.lognormal_lengths(n, **mix["protein_length"]))
    clen = r.permutation(draws.lognormal_lengths(n, **mix["caption_length"]))
    x_p = np.full((n, int(mix["protein_pad"])), ESM_PAD, np.int32)
    x_t = np.full((n, int(mix["caption_pad"])), BERT_PAD, np.int32)
    for i in range(n):
        x_p[i, 0], x_p[i, plen[i] + 1] = ESM_CLS, ESM_EOS
        x_p[i, 1:plen[i] + 1] = r.choice(ESM_AA, size=plen[i])
        x_t[i, 0], x_t[i, clen[i] - 1] = BERT_CLS, BERT_SEP
        x_t[i, 1:clen[i] - 1] = r.integers(BERT_FIRST_WORD, vocab, size=clen[i] - 2)
    return {"x_p": x_p, "x_t": x_t, "plen": plen, "clen": clen}


def run(ctx) -> Outcome:
    mix, s1 = ctx.mix, ctx.config["stage1"]
    dev = ctx.device
    vocab = ref.dims(s1)["bert_vocab"]

    # --- set-up -----------------------------------------------------------
    from biom3_tpu_torch.pipeline.sweep import Stage1SweepRunner

    state = models.seeded_state(ref.layout(s1), draws.sub_seed(ctx.seed, 0), dev)
    engine = models.pencl_engine(s1, state, dev)
    runner = Stage1SweepRunner(engine, device_batch=int(mix["device_batch"]))
    pool = [make_slab(ctx.seed, i, mix, vocab) for i in range(int(mix["pool_slabs"]))]
    for _ in range(int(mix["warmup_slabs"])):
        runner.run(pool[0]["x_t"], pool[0]["x_p"])

    # --- the window ---------------------------------------------------------
    trace = ctx.trace
    if trace is not None:
        trace.start()       # the profiler's start-up stays out of the window
    t_open = time.perf_counter()
    deadline, trace_end = t_open + ctx.seconds, t_open + float(mix["trace_seconds"])
    outputs: dict[int, tuple] = {}
    done, traced = [], None
    while True:
        i = len(done) % len(pool)
        z_t, z_p = runner.run(pool[i]["x_t"], pool[i]["x_p"])
        done.append(i)
        outputs.setdefault(i, (z_t, z_p))
        t = time.perf_counter()
        if trace is not None and trace.active and t >= trace_end:
            trace.stop()
            traced = list(done)
        if t >= deadline:
            break
    t_close = time.perf_counter()
    if trace is not None and trace.active:
        trace.stop()
        traced = list(done)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    pairs = sum(len(pool[i]["plen"]) for i in done)
    ctx.work.update(slabs=[pool[i] for i in (traced or [])], s1=ref.dims(s1))
    metrics = {"pairs_per_s": pairs / (t_close - t_open), "setup_s": t_open - ctx.t_process}

    del runner, engine
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sample = pick_pairs(ctx.seed, pool, sorted(outputs), int(mix["check_pairs"]))
    strict_f32()
    detail = {}
    readings = read_pairs(state, s1, pool, outputs, sample, dev, detail=detail)
    ctx.readings.update(program=readings, detail=detail)
    for name, prec in ctx.controls.items():
        def candidate(x_t, x_p, prec=prec):
            return ref.z_t(state, s1, x_t, prec), ref.z_p(state, s1, x_p, prec)
        ctx.readings[name] = read_pairs(state, s1, pool, outputs, sample, dev,
                                        candidate=candidate)
    checks = [check_le(name, value, mix["limits"][name]) for name, value in readings.items()]
    return Outcome(metrics, attempted=pairs, failed=0, checks=checks, memory_peak_bytes=peak)


def pick_pairs(seed: int, pool, slabs, count: int) -> list[tuple[int, int]]:
    """(slab, row) pairs drawn from the seed among the embedded slabs, the
    longest protein first."""
    cands = [(s, r) for s in slabs for r in range(len(pool[s]["plen"]))]
    longest = max(cands, key=lambda c: pool[c[0]]["plen"][c[1]])
    rest = [c for c in cands if c != longest]
    picks = draws.rng(seed, 4).choice(len(rest), size=min(count - 1, len(rest)), replace=False)
    return [longest] + [rest[j] for j in picks]


@torch.no_grad()
def read_pairs(state, s1, pool, outputs, sample, device, candidate=None,
               detail: dict | None = None) -> dict:
    """``zt_err`` and ``zp_err`` of the sampled pairs; ``candidate(x_t, x_p)
    -> (z_t, z_p)`` replaces the program's outputs (the control).
    ``detail`` gets how far apart the reference puts consecutive sampled
    pairs (what one pair's answer handed to another would read)."""
    zt_err = zp_err = 0.0
    last, apart = None, []
    for s, r in sample:
        slab = pool[s]
        n = int(slab["plen"][r]) + 2
        x_t = torch.as_tensor(slab["x_t"][r:r + 1], device=device)
        x_p = torch.as_tensor(slab["x_p"][r:r + 1, :n], device=device)
        want_t, want_p = ref.z_t(state, s1, x_t), ref.z_p(state, s1, x_p)
        if candidate is None:
            got_t = torch.as_tensor(outputs[s][0][r:r + 1], device=device)
            got_p = torch.as_tensor(outputs[s][1][r:r + 1], device=device)
        else:
            got_t, got_p = candidate(x_t, x_p)
        zt_err = max(zt_err, float((got_t - want_t).norm() / want_t.norm()))
        zp_err = max(zp_err, float((got_p - want_p).norm() / want_p.norm()))
        if last is not None:
            apart.append([float((last[0] - want_t).norm() / want_t.norm()),
                          float((last[1] - want_p).norm() / want_p.norm())])
        last = (want_t, want_p)
    if detail is not None and apart:
        detail["apart_min"] = [min(a[0] for a in apart), min(a[1] for a in apart)]
    return {"zt_err": zt_err, "zp_err": zp_err}
