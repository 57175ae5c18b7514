"""ProteoScribe training steps: samples per second of the Stage-3 train step.

The program: ``training/stage3_task.make_stage3_train_step`` as
``run_train_stage3`` builds it by default — the model in bf16 on f32 master
parameters in ``layer_block`` mode (``attn_impl="layer-block"``: every layer
forward and backward on the kernels), AdamW (``make_optimizer``, no schedule)
and the EMA (``TrainState(with_ema=True)``) — on batches of ``batch`` rows of
length L.

The batches are made from the seed before the window: ``pool_batches``
batches, each row <START>, residues drawn from the 20 amino acids at a length
from fixed Swiss-Prot-like log-normal quantiles (the seed orders them), <END>,
then the pad token to L, and a seeded z_c.  Each step's path and t are drawn
on the card from a generator seeded from ``--seed`` and handed to the step,
which is the call the window makes.

Set-up drives the one train-state object through its first ``check_steps``
steps (which warm every shape), reading each step's loss, the first gradient
from AdamW's first moment (g = m / (1 − β1) after one step) and, after the
last, each parameter's change; then the window runs steps on the same object
until ``--seconds``, and closes after a device synchronise.
``train_samples_per_s`` = steps × rows ÷ the window's seconds.  The first
step that starts past the window's middle is kept: its feed, and device
copies of the state before it (parameters, AdamW's moments and step counts,
the EMA) and after it (parameters, EMA), with its loss — a few device copies
once in the window.

The check: the plain reference runs the same first steps in float32 from the
same seeded weights, batches, paths and t — loss, autograd gradients, AdamW —
and the kept step from the program's state before it — loss, gradients,
AdamW, the EMA.

* ``loss_err``: the largest |program − reference| / |reference| loss;
* ``grad_err``: over the leaves, the largest gap between the program's and
  the reference's first-gradient norm, over the larger of the reference
  leaf's norm and the median leaf's;
* ``update_err``: the same for the parameters' change after the steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone);
* ``mid_loss_err``, ``mid_update_err``: the same of the kept step;
* ``mid_ema_err``: the same for the EMA's change in the kept step, over
  every leaf.  The EMA is compared there and not after the first steps:
  there its change, (1 − β)·(param − EMA), is a few units in the last place
  of a float32 value near 1, so that round-off decides it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import draws, models
from harness.cell import Outcome, check_le
from reference import proteoscribe as ref
from reference.common import FP32, strict_f32

START, END, PAD = 1, 22, 23          # the shifted train ids of <START>, <END>, '-'
AA = np.arange(2, 22)                # the 20 residues, shifted


def make_batch(seed: int, index: int, mix: dict, dims: dict, device) -> dict:
    B, L = int(mix["batch"]), dims["L"]
    r = draws.rng(seed, 1, index)
    lengths = r.permutation(draws.lognormal_lengths(B, **mix["length"]))
    tokens = np.full((B, L), PAD, np.int64)
    for i, n in enumerate(lengths):
        tokens[i, 0], tokens[i, n + 1] = START, END
        tokens[i, 1:n + 1] = r.choice(AA, size=n)
    z_c = r.standard_normal((B, dims["cond"]), dtype=np.float32)
    return {"tokens": torch.as_tensor(tokens, device=device),
            "z_c": torch.as_tensor(z_c, device=device), "lengths": lengths}


def draw_path(generator, B: int, L: int):
    """(path (B, L), t (B,)) on the generator's device: a permutation of
    [0, L) per row and t uniform in [0, L]."""
    path = torch.rand((B, L), generator=generator, device=generator.device).argsort(dim=-1)
    t = torch.randint(0, L + 1, (B,), generator=generator, device=generator.device)
    return path, t


def build_step(s3: dict, state: dict, mix: dict, device):
    """The program's train state on ``state``'s weights → (step, train
    state)."""
    from biom3_tpu_torch.config import Config, ProteoScribeConfig
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe
    from biom3_tpu_torch.training.optim import make_optimizer
    from biom3_tpu_torch.training.stage3_task import make_stage3_train_step
    from biom3_tpu_torch.training.state import TrainState

    cfg = ProteoScribeConfig.from_stage_config(Config(s3))
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    with torch.device(device):
        model = ProteoScribe(cfg, dtype=dtype, attn_impl=mix["attn_impl"])
    model.load_state_dict(state, strict=True)
    tx = make_optimizer("AdamW", model.parameters(), float(mix["lr"]), None,
                        weight_decay=float(mix["weight_decay"]))
    train_state = TrainState(model, tx, with_ema=True)
    return make_stage3_train_step(train_state, ema_beta=float(mix["ema_beta"])), train_state


def run(ctx) -> Outcome:
    mix, s3 = ctx.mix, ctx.config["stage3"]
    dev = ctx.device
    dims = ref.dims(s3)
    B, L = int(mix["batch"]), dims["L"]

    # --- set-up: the train state, its first steps -------------------------
    state = models.seeded_state(ref.layout(s3), draws.sub_seed(ctx.seed, 0), dev, torch.float32)
    step, train_state = build_step(s3, state, mix, dev)
    pool = [make_batch(ctx.seed, i, mix, dims, dev) for i in range(int(mix["pool_batches"]))]
    gen = torch.Generator(device=dev).manual_seed(draws.sub_seed(ctx.seed, 5))
    first = read_first_steps(step, train_state, pool, gen, int(mix["check_steps"]), state, B, L)
    if dev.type == "cuda":
        torch.cuda.synchronize()

    # --- the window ---------------------------------------------------------
    trace = ctx.trace
    if trace is not None:
        trace.start()       # the profiler's start-up stays out of the window
    t_open = tick = time.perf_counter()
    deadline, trace_end = t_open + ctx.seconds, t_open + float(mix["trace_seconds"])
    t_mid = t_open + 0.5 * ctx.seconds
    steps, traced, mid = 0, None, None
    while True:
        batch = pool[(first["steps"] + steps) % len(pool)]
        path, t = draw_path(gen, B, L)
        if mid is None and tick >= t_mid:
            mid = {"feed": (batch, path, t), "before": copy_state(train_state, True)}
            mid["loss"] = step(batch, path=path, t=t)["loss"].detach().clone()
            mid["after"] = copy_state(train_state, False)
        else:
            step(batch, path=path, t=t)
        steps += 1
        tick = time.perf_counter()
        if trace is not None and trace.active and tick >= trace_end:
            trace.stop()
            traced = steps
        if tick >= deadline and mid is not None:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_close = time.perf_counter()
    if trace is not None and trace.active:
        trace.stop()
        traced = steps
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    ctx.work.update(steps=traced or 0, rows=B, dims=dims)
    metrics = {"train_samples_per_s": steps * B / (t_close - t_open),
               "setup_s": t_open - ctx.t_process}

    del step, train_state
    mid["program"] = state_change(mid["before"], mid["after"])
    mid["loss"] = float(mid.pop("loss"))
    del mid["after"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    strict_f32()
    want = reference_steps(state, s3, first, mix)
    want_mid = reference_mid_step(mid, s3, mix)
    detail = {}
    readings = {**compare(first, want, detail), **compare_mid(mid, want_mid)}
    ctx.readings["program"] = readings
    ctx.readings["detail"] = detail
    for name, prec in ctx.controls.items():
        ctx.readings[name] = {**compare(reference_steps(state, s3, first, mix, prec), want),
                              **compare_mid(reference_mid_step(mid, s3, mix, prec), want_mid)}
    checks = [check_le(n, v, mix["limits"][n]) for n, v in readings.items()]
    return Outcome(metrics, attempted=(first["steps"] + steps) * B, failed=0, checks=checks,
                   memory_peak_bytes=peak)


def read_first_steps(step, train_state, pool, gen, count: int, start: dict, B: int, L: int):
    """Run the first ``count`` steps through the window's call, reading the
    losses, the first gradient's leaf norms (AdamW's first moment after one
    step) and the leaves' change after the last."""
    beta1 = train_state.tx.opt.param_groups[0]["betas"][0]
    names, params = train_state.names, train_state.params
    feeds, losses, grad = [], [], {}
    for i in range(count):
        path, t = draw_path(gen, B, L)
        feeds.append((pool[i % len(pool)], path, t))
        aux = step(pool[i % len(pool)], path=path, t=t)
        losses.append(float(aux["loss"]))
        if i == 0:
            # a leaf the optimizer has not stepped has no first moment: 0
            moments = {n: train_state.tx.opt.state.get(p, {}).get("exp_avg")
                       for n, p in zip(names, params)}
            grad = {n: 0.0 if m is None else float(m.float().norm()) / (1.0 - beta1)
                    for n, m in moments.items()}
    change = {n: float((p.detach().float() - start[n].float()).norm())
              for n, p in zip(names, params)}
    return {"steps": count, "feeds": feeds, "loss": losses, "grad": grad, "change": change}


def copy_state(train_state, moments: bool) -> dict:
    """Device copies of the train state's parameters and EMA and, with
    ``moments``, of AdamW's moments and step counts (a leaf the optimizer
    has not stepped has none)."""
    names, params = train_state.names, train_state.params
    out = {"params": {n: p.detach().clone() for n, p in zip(names, params)},
           "ema": {n: e.detach().clone() for n, e in zip(names, train_state.ema_params)}}
    if moments:
        opt = train_state.tx.opt.state
        out["adam"] = {n: [opt[p]["exp_avg"].clone(), opt[p]["exp_avg_sq"].clone(),
                           opt[p]["step"].clone()]
                       for n, p in zip(names, params) if "exp_avg" in opt.get(p, {})}
    return out


def state_change(before: dict, after: dict) -> dict:
    """Each leaf's norm of change of the parameters and of the EMA."""
    return {key: {n: float((after[key][n].float() - v.float()).norm())
                  for n, v in before[key].items()} for key in ("params", "ema")}


def loss_and_grads(params: dict, s3: dict, feed, prec, rows: int):
    """The reference's loss of one step and its gradients, summed over
    blocks of ``rows`` rows so that it fits beside nothing else."""
    batch, path, t = feed
    tokens, z_c = batch["tokens"], batch["z_c"]
    B = tokens.shape[0]
    total = 0.0
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    for r0 in range(0, B, rows):
        sl = slice(r0, min(B, r0 + rows))
        share = (sl.stop - sl.start) / B
        loss = ref.elbo_loss(params, s3, tokens[sl], z_c[sl], path[sl], t[sl], prec) * share
        for g, d in zip(grads.values(), torch.autograd.grad(loss, list(params.values()))):
            g.add_(d)
        total += float(loss.detach())
        del loss
    return total, grads


def reference_steps(state: dict, s3: dict, first: dict, mix: dict, prec=FP32,
                    rows: int = 8) -> dict:
    """The first steps in the plain reference (float32, or ``prec``) from the
    seeded weights."""
    params = {n: v.detach().float().clone().requires_grad_(True) for n, v in state.items()}
    opt, losses, grad = {}, [], {}
    for i, feed in enumerate(first["feeds"]):
        loss, grads = loss_and_grads(params, s3, feed, prec, rows)
        losses.append(loss)
        if i == 0:
            grad = {n: float(g.norm()) for n, g in grads.items()}
        with torch.no_grad():
            ref.adamw_step(params, grads, opt, lr=float(mix["lr"]),
                           weight_decay=float(mix["weight_decay"]))
        del grads
    change = {n: float((p.detach() - state[n].float()).norm()) for n, p in params.items()}
    return {"loss": losses, "grad": grad, "change": change}


def reference_mid_step(mid: dict, s3: dict, mix: dict, prec=FP32, rows: int = 8) -> dict:
    """The kept step in the plain reference from the program's state before
    it: loss, gradients, AdamW on the program's moments, then the EMA."""
    before = mid["before"]
    params = {n: v.float().clone().requires_grad_(True) for n, v in before["params"].items()}
    loss, grads = loss_and_grads(params, s3, mid["feed"], prec, rows)
    opt = {n: [m.float().clone(), v.float().clone(), int(k)]
           for n, (m, v, k) in before["adam"].items()}
    ema = {n: e.float().clone() for n, e in before["ema"].items()}
    with torch.no_grad():
        ref.adamw_step(params, grads, opt, lr=float(mix["lr"]),
                       weight_decay=float(mix["weight_decay"]))
        ref.ema_update(ema, params, float(mix["ema_beta"]))
    after = {"params": {n: p.detach() for n, p in params.items()}, "ema": ema}
    return {"loss": loss, "grad": {n: float(g.norm()) for n, g in grads.items()},
            **state_change(before, after)}


def leaf_gaps(prog: dict, want: dict, names) -> dict:
    """Each leaf's gap of norms, over the larger of the reference leaf's
    norm and the median of ``names``'."""
    med = float(np.median([want[n] for n in names]))
    return {n: abs(prog[n] - want[n]) / max(want[n], med) for n in names}


def moved(grad: dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    g_med = float(np.median(list(grad.values())))
    return [n for n, g in grad.items() if g >= 1e-3 * g_med]


def compare(prog: dict, want: dict, detail: dict | None = None) -> dict:
    """The first steps' three numbers; ``detail`` gets the leaves that read
    the largest update and gradient gaps, with their norms."""
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], want["loss"]))
    g_med = float(np.median(list(want["grad"].values())))
    grad_err = max(abs(prog["grad"][n] - g) / max(g, g_med) for n, g in want["grad"].items())
    kept = moved(want["grad"])
    gaps = leaf_gaps(prog["change"], want["change"], kept)
    update_err = max(gaps.values())
    if detail is not None:
        detail["update_median_gap"] = float(np.median(list(gaps.values())))
        worst = sorted(gaps, key=lambda n: -gaps[n])[:6]
        detail["update_worst"] = [[n, gaps[n], prog["change"][n], want["change"][n],
                                   prog["grad"][n], want["grad"][n]] for n in worst]
        detail["grad_median"] = g_med
        detail["change_median"] = float(np.median([want["change"][n] for n in kept]))
        detail["left_out"] = len(set(want["grad"]) - set(kept))
    return {"loss_err": loss_err, "grad_err": grad_err, "update_err": update_err}


def compare_mid(mid: dict, want: dict) -> dict:
    """The kept step's three numbers: ``mid`` holds the program's loss and
    changes (``mid["program"]``), or is a control's reference step."""
    prog = mid.get("program", mid)
    loss_err = abs(mid["loss"] - want["loss"]) / abs(want["loss"])
    update = leaf_gaps(prog["params"], want["params"], moved(want["grad"]))
    ema = leaf_gaps(prog["ema"], want["ema"], list(want["ema"]))
    return {"mid_loss_err": loss_err, "mid_update_err": max(update.values()),
            "mid_ema_err": max(ema.values())}
