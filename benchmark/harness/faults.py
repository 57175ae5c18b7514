"""Faults planted under the timed path, to show that each cell's comparison
catches them (``test_bench_faults.py`` on the CPU; ``readings.py --fault`` on
the card, for the readings a limit is set from).

* ``unchanged_step``: a step returns its state unchanged — the optimizer
  step is skipped (training); the sampler, or the served trajectory
  dispatch, hands back its starting state, all absorbing;
* ``half_batch``: half of the batch left out — the loss is the mean over the
  first half of the rows (training); the first half's results stand in for
  the second half's (the stack forward of a sweep, a served dispatch, an
  embedding's slab);
* ``token_altered``: a token or an answer altered where it is produced —
  each sampled token moved to the next class (a sweep, a served dispatch);
  the protein embeddings of a slab handed back one row out of place (an
  embedding);
* ``ema_skipped``: the training step leaves its EMA where it was.

There is one card, so the exchange between cards cannot be left out.
Each is a context manager that patches the program and restores it.
"""

from __future__ import annotations

import contextlib

import torch

from harness.models import patched

FAULTS = ("unchanged_step", "half_batch", "token_altered", "ema_skipped")


def _half_rows(out: torch.Tensor) -> torch.Tensor:
    h = (out.shape[0] + 1) // 2
    return torch.cat([out[:h], out[:out.shape[0] - h]])


@contextlib.contextmanager
def planted(fault: str, kind: str):
    """Plant ``fault`` for the traffic ``kind`` ("sweep", "serve", "embed",
    "train")."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    if fault == "ema_skipped" and kind != "train":
        raise ValueError("only a training step keeps an EMA")
    with contextlib.ExitStack() as stack:
        if kind == "train":
            from biom3_tpu_torch.training import stage3_task, state

            if fault == "unchanged_step":
                def make(orig):
                    def apply_gradients(self, ema_beta=0.9999):
                        self.tx.zero_grad()
                        self.step += 1
                    return apply_gradients
                stack.enter_context(patched(state.TrainState, "apply_gradients", make))
            elif fault == "half_batch":
                def make(orig):
                    def loss_fn(model, tokens, z_c, **kw):
                        h = tokens.shape[0] // 2
                        kw = {k: (v[:h] if torch.is_tensor(v) and v.dim() else v)
                              for k, v in kw.items()}
                        return orig(model, tokens[:h], z_c[:h], **kw)
                    return loss_fn
                stack.enter_context(patched(stage3_task, "stage3_loss_fn", make))
            elif fault == "ema_skipped":
                stack.enter_context(patched(state, "ema_update",
                                            lambda orig: lambda ema, params, beta=0.9999: None))
            else:
                raise ValueError("a training step produces no token to alter")
        elif kind == "sweep":
            from biom3_tpu_torch.pipeline import sweep

            if fault == "unchanged_step":
                def make(orig):
                    def make_sampler(*a, **kw):
                        sampler = orig(*a, **kw)
                        return lambda z_c, path, gen=None, **k: torch.zeros_like(
                            sampler(z_c, path, gen, **k))
                    return make_sampler
                stack.enter_context(patched(sweep, "make_sampler", make))
            elif fault == "half_batch":
                from biom3_tpu_torch.pipeline import stage3

                def make(orig):
                    def make_stack_apply(*a, **kw):
                        apply = orig(*a, **kw)
                        return lambda *args: _half_rows(apply(*args))
                    return make_stack_apply
                stack.enter_context(patched(stage3, "make_stack_apply", make))
            else:
                def make(orig):
                    def multinomial(probs, n, *a, **kw):
                        return (orig(probs, n, *a, **kw) + 1) % probs.shape[-1]
                    return multinomial
                stack.enter_context(patched(torch, "multinomial", make))
        elif kind == "serve":
            from biom3_tpu_torch.pipeline import stage3

            def make(orig):
                def make_trajectory_row_fn(engine, mesh=None):
                    row_fn = orig(engine, mesh)

                    def broken(*a, **kw):
                        ids = row_fn(*a, **kw)
                        if fault == "unchanged_step":
                            return torch.zeros_like(ids)
                        if fault == "half_batch":
                            return _half_rows(ids)
                        return (ids + 1) % engine.config.num_classes
                    broken.accepts_masked = row_fn.accepts_masked
                    return broken
                return make_trajectory_row_fn
            stack.enter_context(patched(stage3.ProteoScribeEngine, "make_trajectory_row_fn",
                                         make))
        elif kind == "embed":
            from biom3_tpu_torch.pipeline import stage1

            def make(orig):
                def embed_tokens(self, x_t, x_p):
                    z_t, z_p = orig(self, x_t, x_p)
                    if fault == "token_altered":
                        return z_t, z_p.roll(1, dims=0)
                    return _half_rows(z_t), _half_rows(z_p)
                return embed_tokens
            if fault == "unchanged_step":
                raise ValueError("an embedding has no state to step")
            stack.enter_context(patched(stage1.PenCLEngine, "embed_tokens", make))
        else:
            raise ValueError(f"no faults for traffic kind {kind!r}")
        yield
