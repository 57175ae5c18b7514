"""Stage-3 (ProteoScribe) training task: the OA-ARDM train and eval steps.

Port of ``biom3_tpu/training/stage3_task.py:32-129`` (the reference's
``PL_ProtARDM``, ``Stage3_source/PL_wrapper.py:40-333``): the conditional
ELBO, optional microbatch gradient accumulation (``acc_grad_batches``),
the EMA, and the eval step's metric suite on a cadence.  The step draws
its paths and timesteps from an explicit ``torch.Generator``; the model's
dropout draws from torch's default generator.
"""

from __future__ import annotations

import torch

from biom3_tpu_torch.diffusion.oa_ardm import (
    mask_realizations,
    oa_ardm_loss,
    sample_random_paths,
    sample_timesteps,
)
from biom3_tpu_torch.training.metrics import positional_entropy, time_split_metrics
from biom3_tpu_torch.training.state import TrainState


def stage3_loss_fn(model, tokens: torch.Tensor, z_c: torch.Tensor, *,
                   generator: torch.Generator | None = None, path: torch.Tensor | None = None,
                   t: torch.Tensor | None = None):
    """Loss and diagnostics of one microbatch; tokens (B, L) shifted train
    ids.  ``path``/``t`` are drawn from ``generator`` unless given."""
    B, L = tokens.shape
    if path is None:
        path = sample_random_paths(generator, B, L, device=tokens.device)
    if t is None:
        t = sample_timesteps(generator, B, L, device=tokens.device)
    masked = mask_realizations(tokens, path, t)
    logits = model(masked, t, z_c)
    loss = oa_ardm_loss(logits, tokens, masked, t)
    with torch.no_grad():
        unsampled = masked == 0
        acc = ((logits.argmax(-1) == tokens) & unsampled).sum() / unsampled.sum().clamp(min=1)
    return loss, {"loss": loss.detach(), "acc_unsampled": acc}


def make_stage3_train_step(state: TrainState, *, accum_steps: int = 1, ema_beta: float = 0.9999):
    """→ ``step(batch, generator) -> aux``: one optimizer step on
    ``batch = {"tokens": (B, L), "z_c": (B, cond_dim)}``.  With
    ``accum_steps`` > 1 the batch splits into microbatches whose gradients
    are averaged (the mean of the microbatch losses is differentiated)."""
    model = state.model

    def step(batch: dict, generator: torch.Generator) -> dict:
        model.train()
        tokens, z_c = batch["tokens"], batch["z_c"]
        mb = tokens.shape[0] // accum_steps
        auxes = []
        for i in range(accum_steps):
            sl = slice(i * mb, (i + 1) * mb)
            loss, aux = stage3_loss_fn(model, tokens[sl], z_c[sl], generator=generator)
            (loss / accum_steps).backward()
            auxes.append(aux)
        state.apply_gradients(ema_beta)
        return {k: torch.stack([a[k] for a in auxes]).float().mean() for k in auxes[0]}

    return step


def make_stage3_eval_step(model):
    """→ ``eval_step(batch, generator) -> metrics``: the ELBO plus the
    time-split hard accuracy / entropy-perplexity and positional entropy of
    a sampled reconstruction (the reference's validation_step)."""

    @torch.no_grad()
    def eval_step(batch: dict, generator: torch.Generator) -> dict:
        model.eval()
        tokens, z_c = batch["tokens"], batch["z_c"]
        B, L = tokens.shape
        path = sample_random_paths(generator, B, L, device=tokens.device)
        t = sample_timesteps(generator, B, L, device=tokens.device)
        masked = mask_realizations(tokens, path, t)
        logits = model(masked, t, z_c).float()
        probs = torch.softmax(logits, dim=-1)
        sample = torch.multinomial(probs.reshape(B * L, -1), 1, generator=generator).view(B, L)
        metrics = {"loss": oa_ardm_loss(logits, tokens, masked, t),
                   "pos_entropy": positional_entropy(probs)}
        metrics.update(time_split_metrics(sample, tokens, probs, path, t))
        return metrics

    return eval_step
